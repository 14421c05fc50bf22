"""Parameters held as shards over a mesh: what GSPMD does for the
reference's ``param_shardings`` under ``jit``.

A ``Layout`` says how each leaf is held: for each dim a mesh axis (or a
tuple of axes) it is split over, or None for a dim held whole.  It is the
plan of ``sharding.param_shardings`` with the "model" entries this port
does not hold taken out.  The experts' are always held, E / tp a rank, as
the expert-parallel MoE (``models/moe_ep.py``) uses them.  Under tensor
parallelism (``Layout.tp``: where the model axis has more than one rank,
or where ``force_tp`` asks for it) so is each dense entry that
``sharding.tp_holds`` keeps: heads, d_ff columns and vocab rows, split as
``sharding.tp_splits`` says.  Most splits are the plan's, a contiguous
1/tp of the dim; mamba2's ``in_proj.w`` and conv leaves are split part by
part (``Layout.blocks``: rank r holds the r-th 1/tp of each part, in part
order) and the sLSTM's ``r`` over its heads, dim 0, instead of the plan's
dim 2 (its held spec says so).  The data ("F") entries are FSDP: each
rank holds its slice of the dim as a contiguous tensor of its own, and
the optimizer (kernel 8) updates the slices as its leaves.

``gather`` makes a tree's leaves whole over the data axes for the forward:
an all-gather along each data-sharded dim, whose backward is a
reduce-scatter (sum) of the ranks' partial gradients, so each rank ends
with the sum over the data ranks of its slice's gradient (``llm_a3c``
divides by the data size).  A dense leaf held over "model" keeps its
model shard: the tensor-parallel layer computes on it, and the gradient of
that shard is complete on its rank.  The model layer gathers a block's
leaves inside the block's remat region, cast to the compute dtype first
(the cast is elementwise, so cast-then-gather equals gather-then-cast),
and the backward gathers them again rather than holding whole weights.
The experts' model dim is gathered only for the dense MoE (the rules
choose it; ``models/model.py``), and ``full`` gathers every dim, putting
a blocked leaf's parts back in their order.
"""
from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import collectives, sharding

_EXPERTS = re.compile(r"(^|\.)moe\.w_(gate|up|down)$")


class Layout(NamedTuple):
    """How the leaves of a parameter tree are held over ``mesh``."""
    mesh: object                       # DeviceMesh
    held: Dict[str, tuple]             # path -> axes a dim (None: whole)
    shapes: Dict[str, tuple]           # path -> the whole leaf's shape
    tp: bool = False                   # dense leaves split over "model"
    # path -> (dim, parts) of each leaf split part by part over "model"
    blocks: Optional[Dict[str, Tuple[int, Tuple[int, ...]]]] = None

    def sharded(self, path: str, axis: str) -> bool:
        return any(axis in sharding.entry_axes(a) for a in self.held[path])

    def block(self, path: str) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """(dim, parts) where ``path`` is split part by part, else None."""
        return (self.blocks or {}).get(path)


class TPRule(NamedTuple):
    """Tensor and sequence parallelism over the model group: ``size``
    ranks, this one ``rank``; the model layer takes it as an argument
    (the remat recompute runs where thread-local rules are not seen)."""
    group: Any
    size: int
    rank: int
    vocab: bool                        # embedding and head split over vocab


def _held_spec(path: str, spec: tuple, holds: Dict[str, bool]) -> tuple:
    """The plan's ``spec`` as the port holds it: "model" kept on the
    experts and where ``holds`` (``sharding.tp_holds``) says so."""
    if _EXPERTS.search(path) or holds.get(path):
        return spec
    return sharding.strip_axis(spec, "model")


def layout(cfg, mesh, *, pod_groups: bool = False,
           force_tp: bool = False, fsdp: bool = True) -> Layout:
    """The layout of ``cfg``'s parameters over ``mesh``: the reference's
    FSDP plan, held as ``_held_spec`` says, with the blocked and moved
    splits of ``sharding.tp_splits``.  ``pod_groups``: the delayed-sync
    groups' inner layout, the pod axis stripped from each entry (each pod
    holds a copy).  Tensor and sequence parallelism over the model axis is
    taken where the axis has more than one rank; ``force_tp`` takes it
    over a model axis of one rank too, whose collectives run over a group
    of one.  A layout the port cannot hold (``sharding.tp_refusal``: q
    heads or a recurrent width that do not divide the axis) is a
    ValueError that names its reason; no dense leaf is quietly held
    whole.  ``fsdp=False`` plans the data ("F") entries away, as the
    reference's serving replicas do (``serve_layout``)."""
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    plan = sharding.param_shardings(cfg, mesh, shapes, fsdp=fsdp)
    tp = force_tp or sharding.mesh_shape(mesh).get("model", 1) > 1
    why = sharding.tp_refusal(cfg, mesh) if tp else ""
    if why:
        raise ValueError(why)
    holds = sharding.tp_holds(cfg, mesh, shapes) if tp else {}
    splits = sharding.tp_splits(cfg, mesh, shapes) if tp else {}
    held, blocks = {}, {}
    for path, spec in plan.items():
        if pod_groups:
            spec = sharding.strip_pod(spec)
        spec = _held_spec(path, spec, holds)
        split = splits.get(path)
        if split is not None and split.kind == "moved":
            spec = list(sharding.strip_axis(spec, "model"))
            if spec[split.dim] is not None:
                raise ValueError(f"{path}: dim {split.dim} is held over "
                                 f"{spec[split.dim]} already")
            spec[split.dim] = "model"
            spec = tuple(spec)
        elif split is not None and split.kind == "blocked":
            blocks[path] = (split.dim, split.parts)
        held[path] = spec
    return Layout(mesh, held, {k: tuple(v) for k, v in shapes.items()}, tp,
                  blocks)


def serve_layout(cfg, mesh, *, force_tp: bool = False) -> Layout:
    """The decode layout of the reference's dry run
    (``repro/launch/dryrun.py:179-186``): weights over the model axis
    only, with no FSDP (``param_shardings(..., fsdp=False)``), each model
    rank holding what ``sharding.tp_holds`` holds, split as
    ``sharding.tp_splits`` says (mamba2's blocked leaves, the sLSTM's
    ``r`` over its heads, wk/wv whole where the kv heads do not divide the
    axis), every leaf whole over the data axes.  The weights it holds are
    the serving ones, cast once (``model.cast_params``: bf16 matrices, f32
    vectors).  A config ``sharding.tp_refusal`` refuses raises, naming
    its reason (q heads that do not divide the axis: ROADMAP queue 1 item
    5, slice 6b-iii)."""
    return layout(cfg, mesh, force_tp=force_tp, fsdp=False)


def tp_rule(lay: Optional[Layout]) -> Optional[TPRule]:
    """The model layer's tensor-parallel rule under ``lay`` (None without
    tensor parallelism)."""
    if lay is None or not lay.tp:
        return None
    group = sharding.axes_group(lay.mesh, ("model",))
    return TPRule(group, sharding.axes_size(lay.mesh, ("model",)),
                  sharding.axes_rank(lay.mesh, ("model",)),
                  lay.sharded("embed.table", "model"))


def ep_rule(lay: Layout) -> dict:
    """The ``moe_ep`` rule a tensor-parallel layout implies, as
    ``sharding.activation_rules`` gives it for a batch the data axes
    divide: the experts held E / tp over "model", this rank's rows of the
    batch over every data axis (where ``sharding.shard_batch`` puts
    them)."""
    return {"mesh": lay.mesh, "tp": sharding.axes_size(lay.mesh, ("model",)),
            "dp_axes": sharding.data_axes(lay.mesh)}


def leaf_shard(lay: Layout, path: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole leaf ``t`` at ``path``, contiguous: a
    blocked dim (``Layout.block``) split part by part, the r-th 1/n of each
    part in part order."""
    block = lay.block(path)
    for dim, ax in enumerate(lay.held[path]):
        axes = sharding.entry_axes(ax)
        if not axes:
            continue
        n = sharding.axes_size(lay.mesh, axes)
        r = sharding.axes_rank(lay.mesh, axes)
        if block is not None and block[0] == dim:
            t = torch.cat([p.narrow(dim, r * (p.shape[dim] // n),
                                    p.shape[dim] // n)
                           for p in t.split(list(block[1]), dim)], dim)
            continue
        size = t.shape[dim] // n
        t = t.narrow(dim, r * size, size)
    return t.contiguous()


def _unblock(t: torch.Tensor, dim: int, parts: tuple, n: int
             ) -> torch.Tensor:
    """A blocked dim gathered from ``n`` ranks (each rank's parts laid end
    to end, rank after rank) put back in part order."""
    chunks = [c.split([p // n for p in parts], dim) for c in t.chunk(n, dim)]
    return torch.cat([c[i] for i in range(len(parts)) for c in chunks], dim)


def shard(lay: Layout, params):
    """This rank's shards of a whole parameter tree (every rank holds the
    same whole tree): each a contiguous copy."""
    from repro_torch.models.model import flatten, unflatten
    flat = flatten(params)
    return unflatten({k: leaf_shard(lay, k, t.detach()).clone()
                      for k, t in flat.items()})


def gather_leaf(lay: Layout, path: str, t: torch.Tensor, *,
                model: bool = False) -> torch.Tensor:
    """The leaf gathered over its data axes from this rank's shard,
    differentiably: each data-sharded dim all-gathered, its backward the
    sum of the data ranks' gradients (``collectives.gather_sum``).  A
    model-sharded dim stays this rank's shard unless ``model`` (the dense
    MoE's experts outside tensor parallelism, and ``full``): then it is
    gathered too (a blocked dim's parts put back in order), its backward
    this rank's slice, since the model ranks compute one loss
    (``collectives.gather_slice``)."""
    block = lay.block(path)
    for dim, ax in enumerate(lay.held[path]):
        axes = sharding.entry_axes(ax)
        if not axes or ("model" in axes and not model):
            continue
        fn = collectives.gather_slice if "model" in axes else \
            collectives.gather_sum
        t = fn(t, sharding.axes_group(lay.mesh, axes), dim)
        if block is not None and block[0] == dim:
            t = _unblock(t, dim, block[1], sharding.axes_size(lay.mesh,
                                                              axes))
    return t


def gather(lay: Optional[Layout], prefix: str, tree, *,
           model: bool = False):
    """``gather_leaf`` over a subtree whose paths start with ``prefix``
    (e.g. "layers.3"); the tree itself without a layout."""
    if lay is None:
        return tree
    from repro_torch.models.model import flatten, unflatten
    pre = prefix + "." if prefix else ""
    flat = flatten(tree)
    return unflatten({k: gather_leaf(lay, pre + k, t, model=model)
                      for k, t in flat.items()})


def shard_cache(cfg, mesh, cache, *, batch_size: int):
    """This rank's part of a whole decode cache (every rank holds the same
    whole cache): each tensor leaf cut as ``sharding.cache_shardings``
    lays it out over ``mesh`` (a ``DeviceMesh``), a contiguous copy, and
    mamba2's conv state part by part (x | B | C).  A K/V layer (or a cross
    memory) whose sequence is split records its global length
    (``global_len``), which the ``decode_cp`` rules then own.  Shared
    leaves (one page table behind many layers) stay shared."""
    from repro_torch.models.model import flatten, unflatten
    specs = sharding.cache_shardings(cfg, mesh, cache,
                                     batch_size=batch_size)
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    kinds = cfg.layer_kinds()
    done: Dict[int, torch.Tensor] = {}
    flat = {}
    for path, t in flatten(cache).items():
        if path not in specs:
            flat[path] = t
            continue
        if id(t) in done:
            flat[path] = done[id(t)]
            continue
        parts = path.split(".")
        blocked = parts[0] == "layers" and parts[-1] == "conv" and \
            kinds[int(parts[1])] == "mamba2"
        out = t
        for dim, ax in enumerate(specs[path]):
            axes = sharding.entry_axes(ax)
            if not axes:
                continue
            n = sharding.axes_size(mesh, axes)
            r = sharding.axes_rank(mesh, axes)
            if blocked and dim == out.dim() - 1:
                out = torch.cat([p.narrow(dim, r * (p.shape[dim] // n),
                                          p.shape[dim] // n) for p in
                                 out.split([d_inner, gn, gn], dim)], dim)
                continue
            size = out.shape[dim] // n
            out = out.narrow(dim, r * size, size)
            if dim == 1 and parts[-1] in ("k", "v", "ks", "vs"):
                flat[".".join(parts[:-1] + ["global_len"])] = t.shape[1]
        done[id(t)] = flat[path] = out.contiguous()
    return unflatten(flat)


@torch.no_grad()
def full(lay: Layout, shards):
    """The whole tree from every rank's shards (no gradient): what a
    checkpoint writes."""
    from repro_torch.models.model import flatten, unflatten
    return unflatten({k: gather_leaf(lay, k, t, model=True)
                      for k, t in flatten(shards).items()})
