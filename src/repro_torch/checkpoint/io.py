"""Checkpoints of parameter and optimizer-state trees (npz), with the
contract of ``repro/checkpoint/io.py``: ``restore`` rebuilds the structure
of ``like`` and the shapes must match.

Leaves are stored under their tree paths ("layers.3.attn.wq.w") as numpy
arrays; bf16 leaves are widened to f32 on save (numpy has no bf16, and the
widening is exact) and cast back to ``like``'s dtype on restore.

Under a mesh, with the parameters' ``fsdp.Layout`` (FSDP shards over the
data axes, and under tensor parallelism heads, d_ff columns and vocab rows
over the model axis, mamba2's blocked leaves and the sLSTM's ``r`` over
its heads included): ``save`` gathers each leaf whole over every axis it
is split on (a blocked leaf's parts back in order) and rank 0 writes, so
the file is the single-process file of the same parameters; ``restore``
reads the whole leaves and hands each rank its shards
(``fsdp.leaf_shard``).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import fsdp
from repro_torch.models.model import flatten, tree_map


def save(path: str, tree, layout=None) -> None:
    """Write ``tree``; with ``layout``, ``tree`` is this rank's shards, every
    rank must call, and rank 0 writes the whole leaves."""
    if layout is not None:
        tree = fsdp.full(layout, tree)
        if dist.get_rank() != 0:
            return
    arrays = {}
    for key, leaf in flatten(tree).items():
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arrays[key] = t.numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def restore(path: str, like, layout=None):
    """The tree saved at ``path`` in the structure, dtypes and devices of
    ``like``; raises ValueError if a leaf is missing or its shape differs.
    With ``layout``, ``like`` is this rank's shards and so is the result
    (the saved leaves are whole)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    want = flatten(like)
    if set(arrays) != set(want):
        raise ValueError(f"checkpoint {path}: leaves "
                         f"{sorted(set(arrays) ^ set(want))} differ from "
                         "the tree to restore into")
    for key, leaf in want.items():
        shape = layout.shapes[key] if layout else tuple(leaf.shape)
        if tuple(arrays[key].shape) != shape:
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{arrays[key].shape}, want {shape}")

    def one(key, leaf):
        t = torch.from_numpy(arrays[key])
        if layout is not None:
            t = fsdp.leaf_shard(layout, key, t)
        return t.to(device=leaf.device, dtype=leaf.dtype)
    paths = iter(want)
    return tree_map(lambda leaf: one(next(paths), leaf), like)
