"""Parameters held as shards over a mesh: what GSPMD does for the
reference's ``param_shardings`` under ``jit``.

A ``Layout`` says how each leaf is held: for each dim a mesh axis (or a
tuple of axes) it is split over, or None for a dim held whole.  It is the
plan of ``sharding.param_shardings`` with the "model" entries this port
does not hold taken out.  The experts' are always held, E / tp a rank, as
the expert-parallel MoE (``models/moe_ep.py``) uses them.  Under tensor
parallelism (``Layout.tp``: where the model axis has more than one rank
and ``sharding.tp_covered`` covers the config, or where ``force_tp`` asks
for it) so is each dense entry that ``sharding.tp_holds`` keeps: heads,
d_ff columns and vocab rows.  The configs whose tensor parallelism is a
later slice hold their dense leaves whole on each rank of the model
axis.  The data ("F")
entries are FSDP: each rank holds its slice of the dim as a contiguous
tensor of its own, and the optimizer (kernel 8) updates the slices as its
leaves.

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
choose it; ``models/model.py``), and ``full`` gathers every dim.
"""
from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.distributed import collectives, sharding

_EXPERTS = re.compile(r"(^|\.)moe\.w_(gate|up|down)$")


class Layout(NamedTuple):
    """How the leaves of a parameter tree are held over ``mesh``."""
    mesh: object                       # DeviceMesh
    held: Dict[str, tuple]             # path -> axes a dim (None: whole)
    shapes: Dict[str, tuple]           # path -> the whole leaf's shape
    tp: bool = False                   # dense leaves split over "model"

    def sharded(self, path: str, axis: str) -> bool:
        return any(axis in sharding.entry_axes(a) for a in self.held[path])


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
           force_tp: bool = False) -> Layout:
    """The layout of ``cfg``'s parameters over ``mesh``: the reference's
    FSDP plan, held as ``_held_spec`` says.  ``pod_groups``: the
    delayed-sync groups' inner layout, the pod axis stripped from each
    entry (each pod holds a copy).  Tensor and sequence parallelism over
    the model axis is taken where the axis has more than one rank and the
    slice covers the config's blocks (the others keep the whole dense
    leaves); ``force_tp`` takes it over a model axis of one rank too, whose
    collectives run over a group of one.  A config the slice covers but
    cannot lay out (q heads that do not divide the axis), or ``force_tp``
    for one it does not cover, is a ValueError that names its ROADMAP
    item."""
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    plan = sharding.param_shardings(cfg, mesh, shapes)
    tp = force_tp or (sharding.mesh_shape(mesh).get("model", 1) > 1
                      and sharding.tp_covered(cfg))
    why = sharding.tp_refusal(cfg, mesh) if tp else ""
    if why:
        raise ValueError(why)
    holds = sharding.tp_holds(cfg, mesh, shapes) if tp else {}
    held = {}
    for path, spec in plan.items():
        if pod_groups:
            spec = sharding.strip_pod(spec)
        held[path] = _held_spec(path, spec, holds)
    return Layout(mesh, held, {k: tuple(v) for k, v in shapes.items()}, tp)


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


def local_shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf held as ``spec``, contiguous."""
    for dim, ax in enumerate(spec):
        axes = sharding.entry_axes(ax)
        if not axes:
            continue
        n = sharding.axes_size(mesh, axes)
        size = t.shape[dim] // n
        t = t.narrow(dim, sharding.axes_rank(mesh, axes) * size, size)
    return t.contiguous()


def shard(lay: Layout, params):
    """This rank's shards of a whole parameter tree (every rank holds the
    same whole tree): each a contiguous copy."""
    from repro_torch.models.model import flatten, unflatten
    flat = flatten(params)
    return unflatten({k: local_shard(t.detach(), lay.held[k],
                                     lay.mesh).clone()
                      for k, t in flat.items()})


def gather_leaf(lay: Layout, path: str, t: torch.Tensor, *,
                model: bool = False) -> torch.Tensor:
    """The leaf gathered over its data axes from this rank's shard,
    differentiably: each data-sharded dim all-gathered, its backward the
    sum of the data ranks' gradients (``collectives.gather_sum``).  A
    model-sharded dim stays this rank's shard unless ``model`` (the dense
    MoE's experts outside tensor parallelism, and ``full``): then it is
    gathered too, its backward this rank's slice, since the model ranks
    compute one loss (``collectives.gather_slice``)."""
    for dim, ax in enumerate(lay.held[path]):
        axes = sharding.entry_axes(ax)
        if not axes or ("model" in axes and not model):
            continue
        fn = collectives.gather_slice if "model" in axes else \
            collectives.gather_sum
        t = fn(t, sharding.axes_group(lay.mesh, axes), dim)
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


@torch.no_grad()
def full(lay: Layout, shards):
    """The whole tree from every rank's shards (no gradient): what a
    checkpoint writes."""
    from repro_torch.models.model import flatten, unflatten
    return unflatten({k: gather_leaf(lay, k, t, model=True)
                      for k, t in flatten(shards).items()})
