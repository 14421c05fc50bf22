"""Checkpoints of parameter and optimizer-state trees (npz), with the
contract of ``repro/checkpoint/io.py``: ``restore`` rebuilds the structure
of ``like`` and the shapes must match.

Leaves are stored under their tree paths ("layers.3.attn.wq.w") as numpy
arrays; bf16 leaves are widened to f32 on save (numpy has no bf16, and the
widening is exact) and cast back to ``like``'s dtype on restore.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models.model import flatten, tree_map


def save(path: str, tree) -> None:
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


def restore(path: str, like):
    """The tree saved at ``path`` in the structure, dtypes and devices of
    ``like``; raises ValueError if a leaf is missing or its shape differs."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    want = flatten(like)
    if set(arrays) != set(want):
        raise ValueError(f"checkpoint {path}: leaves "
                         f"{sorted(set(arrays) ^ set(want))} differ from "
                         "the tree to restore into")
    for key, leaf in want.items():
        if tuple(arrays[key].shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path}: {key} has shape "
                             f"{arrays[key].shape}, want {tuple(leaf.shape)}")
    paths = iter(want)
    return tree_map(lambda leaf: torch.from_numpy(arrays[next(paths)]).to(
        device=leaf.device, dtype=leaf.dtype), like)
