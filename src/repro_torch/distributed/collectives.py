"""Counted collectives over ``torch.distributed`` groups, and the autograd
functions built on them.

Each collective checks that its tensor's device matches the group's backend
(a CUDA tensor over NCCL, a CPU tensor over gloo: ``sharding.check_backend``)
and adds one to its count (``counts`` / ``reset_counts``), so a run can show
how many it issued.  A collective over a group of one rank is issued all the
same: with one card the plumbing runs exactly as with many.  The gathers and
the reduce-scatter take the tensor forms, on the ranks' chunks laid one
after another: along dim 0, or over one rank, no copy at all; along another dim, one
copy that moves whole rows of a chunk (no transpose).  The gathered leaf
is contiguous, laid out as the whole leaf is, so a matrix product takes
the kernel and the sum order it takes on the whole leaf.  Newer
torch names them ``all_gather_single`` / ``reduce_scatter_single`` and
warns on the older ``all_gather_into_tensor`` / ``reduce_scatter_tensor``;
the newer name is taken where it exists.

The autograd functions, by what their backward assumes of the cotangent:

* ``gather_sum``: all-gather along a dim; backward reduce-scatter (sum,
  in the cotangent's dtype: the input is the shard cast to the compute
  dtype, whose gradient is that dtype).  Each rank's cotangent is its own
  partial gradient (FSDP over the data axis: each rank backpropagates its
  own batch rows).
* ``gather_slice``: all-gather along a dim; backward this rank's slice.
  The ranks hold equal cotangents (the model axis: every model rank
  computes the same loss).
* ``scatter_slice``: this rank's slice along a dim; backward all-gather.
  The inverse pair of ``gather_slice``.
* ``sum_grads``: the identity; backward all-reduce (sum).  A tensor held
  whole on every rank of the group and used by each on different data
  (the router over each rank's tokens).
* ``all_to_all``: ``dist.all_to_all_single`` over dim 0; its backward is
  the same exchange of the cotangent, which sends each chunk back.
* ``scatter_sum``: reduce-scatter (sum) along a dim; backward all-gather.
  The inverse pair of ``gather_sum``: Megatron-SP takes a row-parallel
  product's partial sums (B, S, d) to this rank's sequence rows with it,
  and the cotangent of those rows, gathered, is every rank's cotangent of
  its partial sum.
* ``sum_over``: all-reduce (sum) forward; backward the identity.  Sums of
  per-rank partials (the vocab-parallel loss's) after which every rank of
  the group computes the same function: each rank's cotangent of the sum
  is already the whole one, and it is its partial's.
* ``max_over``: the group's elementwise max, without a gradient (the
  vocab-parallel log-sum-exp's shift, which the loss does not depend on).
* ``mean_over``: the mean of a scalar over a group of ``n`` ranks whose
  losses come in ``copies`` equal copies (the model axis computes one
  loss); backward the group's sum of the cotangent over n * copies, each
  loss's cotangent counted once.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding

_COUNTS = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0,
           "all_to_all": 0}


def counts() -> Dict[str, int]:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _issue(kind: str, group, t: torch.Tensor) -> None:
    sharding.check_backend(group, t.device)
    _COUNTS[kind] += 1


_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order
    (contiguous)."""
    _issue("all_gather", group, x)
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _GATHER(out, x, group=group)
    out = out.view(n, *x.shape)                # the ranks' chunks stacked
    return out.movedim(0, dim).flatten(dim, dim + 1).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's chunk along ``dim``
    (contiguous)."""
    _issue("reduce_scatter", group, x)
    n = dist.get_world_size(group)
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    parts = parts.contiguous()
    out = x.new_empty(parts.shape[1:])
    _REDUCE_SCATTER(out, parts.flatten(0, 1), group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks, written into ``x``; returns ``x``."""
    _issue("all_reduce", group, x)
    dist.all_reduce(x, group=group)
    return x


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of partial products ``x`` (no gradient),
    taken in f32 and rounded once to ``x``'s dtype: one all-reduce of an
    f32 copy.  A bf16 sum would round each rank's partial and every
    addition; the decode step's partials are a few rows, so the f32 bytes
    cost nothing."""
    if x.dtype == torch.float32:
        return all_reduce(x, group)
    return all_reduce(x.float(), group).to(x.dtype)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    _issue("all_to_all", group, x)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _ScatterSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, copies):
        ctx.group, ctx.copies = group, copies
        ctx.n = dist.get_world_size(group)
        return all_reduce(x.detach().clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.detach().clone(), ctx.group)
        return g / (ctx.n * ctx.copies), None, None


def gather_sum(x, group, dim: int = 0):
    return _GatherSum.apply(x, group, dim)


def gather_slice(x, group, dim: int = 0):
    return _GatherSlice.apply(x, group, dim)


def scatter_slice(x, group, dim: int = 0):
    return _ScatterSlice.apply(x, group, dim)


def sum_grads(x, group):
    return _SumGrads.apply(x, group)


def all_to_all(x, group):
    return _AllToAll.apply(x, group)


def scatter_sum(x, group, dim: int = 0):
    return _ScatterSum.apply(x, group, dim)


def sum_over(x, group):
    return _SumOver.apply(x, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group's ranks (a copy, no gradient);
    counted as an all-reduce."""
    _issue("all_reduce", group, x)
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def mean_over(x, group, copies: int = 1):
    return _MeanOver.apply(x, group, copies)
