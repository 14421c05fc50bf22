"""Wrappers of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``,
``csrc/rmsnorm_bwd.cu``).

Replace ``repro/kernels/rmsnorm.py::rmsnorm_fwd`` and ``rmsnorm_bwd``.  A
CUDA tensor launches the kernel (or raises); a CPU tensor takes
``ref.rmsnorm_ref`` / ``ref.rmsnorm_bwd_ref``.  Both kernels walk the rows
with a persistent grid laid out by ``row_plan`` (csrc/rmsnorm_rows.cuh).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, ref

launches = 0        # forward launches since the last reset (dispatch.reset_...)
bwd_launches = 0    # backward launches since the last reset

THREADS = 256                 # csrc/rmsnorm_rows.cuh rn::kThreads
CHUNKS = (1, 2, 4, 8)         # 16-byte chunks a thread owns in a row
BLOCKS_PER_SM = 2


def row_plan(rows: int, d: int, itemsize: int,
             sm_count: int) -> Tuple[int, int, int]:
    """(n_blocks, rows_per_block, chunks) of the RMSNorm kernels: block b
    takes rows [b * rows_per_block, (b + 1) * rows_per_block), at most
    BLOCKS_PER_SM blocks an SM, and each of its THREADS threads owns
    ``chunks`` 16-byte chunks of every row, the fewest that cover d.
    A function of the shapes alone."""
    nvec = d * itemsize // 16
    fits = [c for c in CHUNKS if c * THREADS >= nvec]
    if not fits:
        raise ValueError(f"rmsnorm: d={d} is wider than the kernels' "
                         f"{CHUNKS[-1] * THREADS} 16-byte chunks a row")
    per = max(1, -(-rows // (BLOCKS_PER_SM * sm_count)))
    return -(-rows // per), per, fits[0]


def _check_rows(what: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    build.require(x.dim() == 2, what, f"x must be (rows, d), got "
                  f"{tuple(x.shape)}")
    d = x.shape[1]
    build.require(tuple(scale.shape) == (d,), what,
                  f"scale {tuple(scale.shape)} does not match d={d}")
    build.require(x.dtype in build.DTYPE_CODE, what,
                  f"x dtype {x.dtype} (want float32 or bfloat16)")
    build.require(scale.dtype == torch.float32, what,
                  f"scale dtype {scale.dtype} (want float32)")
    build.require(x.device == scale.device, what,
                  f"x on {x.device}, scale on {scale.device}")


def _check_card_rows(what: str, *rows: torch.Tensor) -> None:
    """The kernels move 16 bytes at a time: contiguous rows of whole
    16-byte chunks on 16-byte boundaries."""
    x = rows[0]
    build.require(x.is_cuda, what, f"unsupported device {x.device}")
    build.require(all(t.is_contiguous() for t in rows), what,
                  "inputs must be contiguous")
    vec = 16 // x.element_size()
    build.require(x.shape[1] % vec == 0, what,
                  f"d={x.shape[1]} must be a multiple of {vec} for {x.dtype} "
                  "(the kernel moves 16 bytes at a time)")
    build.require(all(t.data_ptr() % 16 == 0 for t in rows), what,
                  "x must start on a 16-byte boundary")


def _plan(what: str, x: torch.Tensor) -> Tuple[int, int, int]:
    rows, d = x.shape
    try:
        return row_plan(rows, d, x.element_size(),
                        build.sm_count(x.device.index or 0))
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                save_residuals: bool = False):
    """x (rows, d) f32 or bf16, contiguous; scale (d,) f32 -> (rows, d) in
    x's dtype, plus the per-row rstd (rows,) f32 with ``save_residuals``.
    On the card, rows are whole 16-byte chunks on 16-byte boundaries."""
    what = "rmsnorm_fwd"
    _check_rows(what, x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps,
                               save_residuals=save_residuals)
    _check_card_rows(what, x)
    build.require(scale.is_contiguous(), what, "inputs must be contiguous")
    rows, d = x.shape
    _, per, chunks = _plan(what, x)
    y = torch.empty_like(x)
    rstd = (torch.empty(rows, dtype=torch.float32, device=x.device)
            if save_residuals else None)
    rc = build.library().rt_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(),
        rstd.data_ptr() if rstd is not None else None, rows, d, per, chunks,
        float(eps), build.DTYPE_CODE[x.dtype], build.stream_of(x))
    build.check(rc, what)
    global launches
    launches += 1
    return (y, rstd) if save_residuals else y


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                dy: torch.Tensor):
    """One-pass dx / dscale from the forward's rstd.  x, dy (rows, d) in one
    dtype; scale (d,) f32; rstd (rows,) f32 -> (dx (rows, d) in x's dtype,
    dscale (d,) f32).  The kernel writes one dscale row per block and a
    second launch adds them in a fixed order, as the TPU wrapper sums its
    block partials."""
    what = "rmsnorm_bwd"
    _check_rows(what, x, scale)
    rows, d = x.shape
    build.require(dy.shape == x.shape and dy.dtype == x.dtype, what,
                  f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                  f"{tuple(x.shape)} {x.dtype}")
    build.require(tuple(rstd.shape) == (rows,) and
                  rstd.dtype == torch.float32, what,
                  f"want rstd ({rows},) float32, got {tuple(rstd.shape)} "
                  f"{rstd.dtype}")
    build.require(len({t.device for t in (x, scale, rstd, dy)}) == 1, what,
                  "inputs on different devices")
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd_ref(x, scale, rstd, dy)
    _check_card_rows(what, x, dy)
    build.require(scale.is_contiguous() and rstd.is_contiguous(), what,
                  "inputs must be contiguous")
    n_blocks, per, chunks = _plan(what, x)
    dx = torch.empty_like(x)
    part = torch.empty((n_blocks, d), dtype=torch.float32, device=x.device)
    # no rows: nothing is launched, and dscale is a sum over nothing
    dscale = (torch.empty if n_blocks else torch.zeros)(
        d, dtype=torch.float32, device=x.device)
    rc = build.library().rt_rmsnorm_bwd(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dscale.data_ptr(), rows, d, per,
        chunks, build.DTYPE_CODE[x.dtype], build.stream_of(x))
    build.check(rc, what)
    global bwd_launches
    bwd_launches += 1
    return dx, dscale
