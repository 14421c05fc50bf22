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
1/tp of the dim (under the attention's sequence arm, ``Layout.seq``, wq's
columns and wo's rows off head boundaries); mamba2's ``in_proj.w`` and
conv leaves are split part by part (``Layout.blocks``: rank r holds the
r-th 1/tp of each part, in part order) and the sLSTM's ``r`` over its
heads, dim 0, instead of the plan's dim 2 (its held spec says so; under
the head-split arm, ``Layout.head_split`` g ranks a head, a
``sharding.Grouped`` entry: each head's block whole on its g ranks).  The
data ("F") entries are FSDP: each rank holds its slice of the dim as a
contiguous tensor of its own, and the optimizer (kernel 8) updates the
slices as its leaves.

``gather`` makes a tree's leaves whole over the data axes for the forward:
an all-gather along each data-sharded dim, whose backward is a
reduce-scatter (sum) of the ranks' partial gradients, so each rank ends
with the sum over the data ranks of its slice's gradient (``llm_a3c``
divides by the data size).  A dense leaf held over "model" keeps its
model shard: the tensor-parallel layer computes on it, and the gradient of
that shard is complete on its rank.  Under the sequence arm the
attention's model-held leaves are gathered over "model" as well, their
backward a reduce-scatter too (``gather_leaf(model="sum")``): each model
rank's rows give its own part of their gradient.  The model layer
gathers a block's leaves inside the block's remat region, cast to the
compute dtype first (the cast is elementwise, so cast-then-gather equals
gather-then-cast), and the backward gathers them again rather than
holding whole weights.
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
    # the attention's sequence arm (train) / column arm (decode)
    seq: bool = False
    # the ranks each xLSTM head is split over (the head-split arm), 0
    # without it
    head_split: int = 0

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
    # the attention's sequence arm: each rank attends its rows of the
    # sequence against the whole sequence's keys (train), or projects its
    # columns of q, k, v (decode), where the q heads do not divide the group
    seq: bool = False
    # the head-split arm: the g ranks each xLSTM head is split over (0
    # without it); rank r works on the heads its d_inner / tp features
    # fall in, head r // g where g > 1
    head_split: int = 0


def _held_spec(path: str, spec: tuple, holds: Dict[str, bool]) -> tuple:
    """The plan's ``spec`` as the port holds it: "model" kept on the
    experts and where ``holds`` (``sharding.tp_holds``) says so."""
    if _EXPERTS.search(path) or holds.get(path):
        return spec
    return sharding.strip_axis(spec, "model")


def layout(cfg, mesh, *, pod_groups: bool = False,
           force_tp: bool = False, fsdp: bool = True,
           force_seq: bool = False, force_head_split: bool = False
           ) -> Layout:
    """The layout of ``cfg``'s parameters over ``mesh``: the reference's
    FSDP plan, held as ``_held_spec`` says, with the blocked and moved
    splits of ``sharding.tp_splits``.  ``pod_groups``: the delayed-sync
    groups' inner layout, the pod axis stripped from each entry (each pod
    holds a copy).  Tensor and sequence parallelism over the model axis is
    taken where the axis has more than one rank; ``force_tp`` takes it
    over a model axis of one rank too, whose collectives run over a group
    of one.  Where the q heads do not divide the axis the attention takes
    the sequence arm (``sharding.seq_attention``); ``force_seq`` takes it
    (and tensor parallelism) over an axis whose heads divide, a check of
    that arm over a group of one that no CLI asks for.  Where the model
    axis is wider than the xLSTM heads and a multiple of them each head is
    split over g = tp / H ranks (``sharding.head_split``, ``head_split``);
    ``force_head_split`` takes that arm's code (and tensor parallelism)
    where the heads divide the axis, g = 1, again a check.  A layout the
    port cannot hold (``sharding.tp_refusal``: a recurrent width or d_ff
    that does not divide the axis) is a ValueError that names its reason;
    no dense leaf is quietly held whole.  ``fsdp=False`` plans the data
    ("F") entries away, as the reference's serving replicas do
    (``serve_layout``)."""
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    plan = sharding.param_shardings(cfg, mesh, shapes, fsdp=fsdp)
    tp = force_tp or force_seq or force_head_split or \
        sharding.mesh_shape(mesh).get("model", 1) > 1
    why = sharding.tp_refusal(cfg, mesh) if tp else ""
    if force_head_split and not set(cfg.layer_kinds()) & {"mlstm", "slstm"}:
        why = f"{cfg.name}: no xLSTM block has heads to split"
    if why:
        raise ValueError(why)
    seq = tp and (force_seq or sharding.seq_attention(cfg, mesh))
    g = sharding.head_split(cfg, mesh) if tp else 0
    if tp and force_head_split:
        g = g or 1
    holds = sharding.tp_holds(cfg, mesh, shapes) if tp else {}
    splits = sharding.tp_splits(cfg, mesh, shapes) if tp else {}
    held, blocks = {}, {}
    for path, spec in plan.items():
        if pod_groups:
            spec = sharding.strip_pod(spec)
        spec = _held_spec(path, spec, holds)
        split = splits.get(path)
        if split is not None and split.kind in ("moved", "grouped"):
            spec = list(sharding.strip_axis(spec, "model"))
            if spec[split.dim] is not None:
                raise ValueError(f"{path}: dim {split.dim} is held over "
                                 f"{spec[split.dim]} already")
            spec[split.dim] = "model" if split.kind == "moved" else \
                sharding.Grouped("model", split.g)
            spec = tuple(spec)
        elif split is not None and split.kind == "blocked":
            blocks[path] = (split.dim, split.parts)
        held[path] = spec
    return Layout(mesh, held, {k: tuple(v) for k, v in shapes.items()}, tp,
                  blocks, seq, g)


def serve_layout(cfg, mesh, *, force_tp: bool = False,
                 force_seq: bool = False,
                 force_head_split: bool = False) -> Layout:
    """The decode layout of the reference's dry run
    (``repro/launch/dryrun.py:179-186``): weights over the model axis
    only, with no FSDP (``param_shardings(..., fsdp=False)``), each model
    rank holding what ``sharding.tp_holds`` holds, split as
    ``sharding.tp_splits`` says (mamba2's blocked leaves, the sLSTM's
    ``r`` over its heads, wk/wv whole where the kv heads do not divide the
    axis), every leaf whole over the data axes.  The weights it holds are
    the serving ones, cast once (``model.cast_params``: bf16 matrices, f32
    vectors).  Where the q heads do not divide the axis (or with
    ``force_seq``) wq, wk and wv are held as the plan's contiguous column
    split and wo as its row split, off head boundaries (wk and wv whole
    where the kv heads do not divide either), and the attention takes
    the column arm (``Layout.seq``).  Under the head-split arm
    (``Layout.head_split``) the sLSTM's ``r`` is held a head a group of g
    ranks.  A config ``sharding.tp_refusal`` refuses raises, naming its
    reason."""
    return layout(cfg, mesh, force_tp=force_tp, fsdp=False,
                  force_seq=force_seq, force_head_split=force_head_split)


def tp_rule(lay: Optional[Layout]) -> Optional[TPRule]:
    """The model layer's tensor-parallel rule under ``lay`` (None without
    tensor parallelism)."""
    if lay is None or not lay.tp:
        return None
    group = sharding.axes_group(lay.mesh, ("model",))
    return TPRule(group, sharding.axes_size(lay.mesh, ("model",)),
                  sharding.axes_rank(lay.mesh, ("model",)),
                  lay.sharded("embed.table", "model"), lay.seq,
                  lay.head_split)


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
    part in part order; a ``sharding.Grouped`` dim cut as it says."""
    block = lay.block(path)
    for dim, ax in enumerate(lay.held[path]):
        if not sharding.entry_axes(ax):
            continue
        n = sharding.entry_parts(lay.mesh, ax)
        r = sharding.entry_index(lay.mesh, ax)
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
                model: Optional[str] = None) -> torch.Tensor:
    """The leaf gathered over its data axes from this rank's shard,
    differentiably: each data-sharded dim all-gathered, its backward the
    sum of the data ranks' gradients (``collectives.gather_sum``).  A
    model-sharded dim stays this rank's shard unless ``model`` says how to
    gather it (a blocked dim's parts put back in order): "slice" (the
    dense MoE's experts outside tensor parallelism, and ``full``), its
    backward this rank's slice, since the model ranks compute one loss
    (``collectives.gather_slice``); "sum" (the attention's leaves under
    the sequence arm, used by each model rank on its own rows), its
    backward the reduce-scatter of the ranks' gradients
    (``collectives.gather_sum``).  A ``sharding.Grouped`` head dim (each
    head whole on its g ranks) is gathered only to be whole ("slice"): the
    gathered copies of each head after the first are dropped."""
    block = lay.block(path)
    for dim, ax in enumerate(lay.held[path]):
        axes = sharding.entry_axes(ax)
        if not axes or ("model" in axes and model is None):
            continue
        grouped = isinstance(ax, sharding.Grouped)
        if grouped and (ax.inner or model != "slice"):
            raise ValueError(f"{path}: a grouped dim is gathered whole "
                             "only (model='slice')")
        fn = collectives.gather_slice if "model" in axes and \
            model == "slice" else collectives.gather_sum
        t = fn(t, sharding.axes_group(lay.mesh, axes), dim)
        if grouped:
            parts = sharding.entry_parts(lay.mesh, ax)
            t = t.unflatten(dim, (parts, ax.g, -1)).select(
                dim + 1, 0).flatten(dim, dim + 1)
        if block is not None and block[0] == dim:
            t = _unblock(t, dim, block[1], sharding.axes_size(lay.mesh,
                                                              axes))
    return t


def gather(lay: Optional[Layout], prefix: str, tree, *,
           model: Optional[str] = None, model_sum: Tuple[str, ...] = ()):
    """``gather_leaf`` over a subtree whose paths start with ``prefix``
    (e.g. "layers.3"); the tree itself without a layout.  The leaves
    under the subtrees named in ``model_sum`` (e.g. "attn") take
    ``model="sum"``, the others ``model``."""
    if lay is None:
        return tree
    from repro_torch.models.model import flatten, unflatten
    pre = prefix + "." if prefix else ""
    flat = flatten(tree)
    return unflatten({k: gather_leaf(
        lay, pre + k, t,
        model="sum" if k.split(".", 1)[0] in model_sum else model)
        for k, t in flat.items()})


def shard_cache(cfg, mesh, cache, *, batch_size: int):
    """This rank's part of a whole decode cache (every rank holds the same
    whole cache): each tensor leaf cut as ``sharding.cache_shardings``
    lays it out over ``mesh`` (a ``DeviceMesh``), a contiguous copy (a
    ``sharding.Grouped`` dim cut as it says), and mamba2's conv state part
    by part (x | B | C).  A K/V layer (or a cross
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
            if not sharding.entry_axes(ax):
                continue
            n = sharding.entry_parts(mesh, ax)
            r = sharding.entry_index(mesh, ax)
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
    return unflatten({k: gather_leaf(lay, k, t, model="slice")
                      for k, t in flatten(shards).items()})
