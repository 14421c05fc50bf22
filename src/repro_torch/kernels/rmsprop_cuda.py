"""Wrapper of the CUDA Shared-RMSProp update (``csrc/rmsprop.cu``).

Replaces ``repro/kernels/shared_rmsprop.py::rmsprop_update_2d`` together
with the lane padding of the JAX ``dispatch.rmsprop_update``: the kernel
takes flat leaves of any size, up to ``MAX_LEAVES`` of them a launch.  A
CUDA tensor launches the kernel (or raises); a CPU tensor takes
``ref.rmsprop_update_ref``, leaf by leaf.

Three entries, each counted apart: ``rmsprop_update`` (one leaf, update
mode), ``rmsprop_update_multi`` (many leaves, update mode: g' and the
updates) and ``rmsprop_apply_multi`` (many leaves, apply mode: g' and
p - update written in place, the update never stored).  ``plan`` lays the
leaves out over launches and blocks of SPAN elements.
"""
from __future__ import annotations

from array import array
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (dispatch.reset_launch_counts)
launches = 0            # rmsprop_update: one leaf a launch
multi_launches = 0      # rmsprop_update_multi
apply_launches = 0      # rmsprop_apply_multi

MAX_LEAVES = 64         # leaves a launch (csrc/rmsprop.cu, kMaxLeaves)
SPAN = 1024             # elements a block (csrc/rmsprop.cu, kSpan)


def plan(sizes: Sequence[int]) -> List[Tuple[int, int, List[int]]]:
    """The launches of one update over leaves of ``sizes`` elements: a
    list of (first leaf, end leaf, blocks) with at most MAX_LEAVES leaves a
    launch; ``blocks`` (end - first + 1 ints) holds each leaf's first block
    in its launch and, last, the launch's total (ceil(n / SPAN) blocks a
    leaf).  Plain Python: an RL update lays out 13 leaves on the host."""
    if any(n <= 0 for n in sizes):
        raise ValueError(f"rmsprop: empty leaves {list(sizes)}")
    out = []
    for lo in range(0, len(sizes), MAX_LEAVES):
        hi = min(lo + MAX_LEAVES, len(sizes))
        blocks = [0]
        for n in sizes[lo:hi]:
            blocks.append(blocks[-1] - (-n // SPAN))
        if blocks[-1] >= 2 ** 31:
            raise ValueError(f"rmsprop: {blocks[-1]} blocks in one launch")
        out.append((lo, hi, blocks))
    return out


def _check(what: str, gs, grads, outs) -> None:
    """Raise unless every leaf's g, grad and p (``outs``, or g itself)
    agree in shape, are f32 and lie on one device.  The messages are
    built only for a leaf that fails: an RL update checks its leaves on
    the host every time."""
    build.require(len(gs) == len(grads) and
                  (outs is None or len(outs) == len(gs)), what,
                  "one accumulator, gradient (and parameter) a leaf")
    f32, dev = torch.float32, gs[0].device
    for i, (g, d) in enumerate(zip(gs, grads)):
        p = g if outs is None else outs[i]
        if (g.dtype is f32 and d.dtype is f32 and p.dtype is f32 and
                g.shape == d.shape == p.shape and
                g.device == d.device == p.device == dev):
            continue
        build.require(g.shape == d.shape == p.shape, what,
                      f"leaf {i}: g {tuple(g.shape)}, grad {tuple(d.shape)}"
                      f" and p {tuple(p.shape)} differ")
        build.require(g.dtype == d.dtype == p.dtype == f32, what,
                      f"leaf {i}: dtypes g {g.dtype}, grad {d.dtype}, p "
                      f"{p.dtype} (want float32)")
        build.require(False, what, f"leaf {i}: g on {g.device}, grad on "
                      f"{d.device}, p on {p.device}, leaf 0 on {dev}")


def _launch(what: str, gs, grads, outs, apply: bool, lr, alpha,
            eps) -> int:
    """Launches the kernel over the leaves (outs: the updates or the
    parameters); returns the number of launches."""
    build.require(gs[0].is_cuda, what, "unsupported device")
    rows = []
    for g, d, o in zip(gs, grads, outs):
        if not (g.is_contiguous() and d.is_contiguous() and
                o.is_contiguous()):
            raise ValueError(f"{what}: leaves must be contiguous")
        ptrs = (g.data_ptr(), d.data_ptr(), o.data_ptr())
        if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
            raise ValueError(f"{what}: leaves must start on 16-byte "
                             "boundaries (the kernel moves 16 bytes at a "
                             "time)")
        rows.append(ptrs + (g.numel(),))
    lib, stream = build.library(), build.stream_of(gs[0])
    steps = plan([r[3] for r in rows])
    for lo, hi, blocks in steps:
        # (g, grad, out, n, first block) a leaf, read by the C entry
        table = array("q", [x for i in range(lo, hi)
                            for x in rows[i] + (blocks[i - lo],)])
        rc = lib.rt_rmsprop_multi(table.buffer_info()[0], hi - lo,
                                  blocks[-1], int(apply), float(lr),
                                  float(alpha), float(1.0 - alpha),
                                  float(eps), stream)
        build.check(rc, what)
    return len(steps)


def rmsprop_update(g: torch.Tensor, grad: torch.Tensor, *, lr: float,
                   alpha: float = 0.99, eps: float = 0.1):
    """Paper Eq. 8-9 for one f32 leaf of any shape.  Writes
    g' = alpha * g + (1 - alpha) * grad^2 over ``g`` (in place, on both
    devices) and returns (g, update), update = lr * grad / sqrt(g' + eps).
    ``lr`` is a host float: nothing waits on the device."""
    what = "rmsprop_update"
    _check(what, [g], [grad], None)
    if g.device.type == "cpu":
        new_g, upd = ref.rmsprop_update_ref(g, grad, lr=lr, alpha=alpha,
                                            eps=eps)
        return g.copy_(new_g), upd
    upd = torch.empty_like(grad)
    global launches
    launches += _launch(what, [g], [grad], [upd], False, lr, alpha, eps)
    return g, upd


def rmsprop_update_multi(gs: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor], *, lr: float,
                         alpha: float = 0.99,
                         eps: float = 0.1) -> List[torch.Tensor]:
    """``rmsprop_update`` over many leaves in ceil(leaves / MAX_LEAVES)
    launches: g' over each ``gs`` leaf in place; returns the updates (views
    of one buffer, each leaf's on a 16-byte boundary)."""
    what = "rmsprop_update_multi"
    if not gs:
        return []
    _check(what, gs, grads, None)
    if gs[0].device.type == "cpu":
        out = []
        for g, d in zip(gs, grads):
            new_g, upd = ref.rmsprop_update_ref(g, d, lr=lr, alpha=alpha,
                                                eps=eps)
            g.copy_(new_g)
            out.append(upd)
        return out
    starts = [0]
    for g in gs:
        starts.append(starts[-1] - (-g.numel() // 4) * 4)
    flat = torch.empty(starts[-1], dtype=torch.float32, device=gs[0].device)
    upds = [flat[s:s + g.numel()].view(g.shape) for s, g in zip(starts, gs)]
    global multi_launches
    multi_launches += _launch(what, gs, grads, upds, False, lr, alpha, eps)
    return upds


def rmsprop_apply_multi(params: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor], *, lr: float,
                        alpha: float = 0.99, eps: float = 0.1) -> None:
    """One Shared-RMSProp step over many leaves, in place: g' over each
    ``gs`` leaf and p - update over each ``params`` leaf, in
    ceil(leaves / MAX_LEAVES) launches; the update is never stored.  The
    same bits as ``rmsprop_update`` followed by ``p.sub_(update)``."""
    what = "rmsprop_apply_multi"
    if not gs:
        return
    _check(what, gs, grads, params)
    if gs[0].device.type == "cpu":
        for p, g, d in zip(params, gs, grads):
            new_g, upd = ref.rmsprop_update_ref(g, d, lr=lr, alpha=alpha,
                                                eps=eps)
            g.copy_(new_g)
            p.sub_(upd)
        return
    global apply_launches
    apply_launches += _launch(what, gs, grads, params, True, lr, alpha, eps)
