"""Wrapper of the CUDA RMSNorm forward (``csrc/rmsnorm.cu``).

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_fwd``.  A CUDA tensor launches
the kernel (or raises); a CPU tensor takes ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0    # kernel launches since the last reset (dispatch.reset_...)


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """x (rows, d) f32 or bf16, contiguous; scale (d,) f32 -> (rows, d) in
    x's dtype.  On the card, rows are whole 16-byte chunks on 16-byte
    boundaries."""
    what = "rmsnorm_fwd"
    build.require(x.dim() == 2, what, f"x must be (rows, d), got "
                  f"{tuple(x.shape)}")
    rows, d = x.shape
    build.require(tuple(scale.shape) == (d,), what,
                  f"scale {tuple(scale.shape)} does not match d={d}")
    build.require(x.dtype in build.DTYPE_CODE, what,
                  f"x dtype {x.dtype} (want float32 or bfloat16)")
    build.require(scale.dtype == torch.float32, what,
                  f"scale dtype {scale.dtype} (want float32)")
    build.require(x.device == scale.device, what,
                  f"x on {x.device}, scale on {scale.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    build.require(x.is_cuda, what, f"unsupported device {x.device}")
    build.require(x.is_contiguous() and scale.is_contiguous(), what,
                  "inputs must be contiguous")
    vec = 16 // x.element_size()
    build.require(d % vec == 0, what, f"d={d} must be a multiple of {vec} "
                  f"for {x.dtype} (the kernel moves 16 bytes at a time)")
    build.require(x.data_ptr() % 16 == 0, what,
                  "x must start on a 16-byte boundary")
    y = torch.empty_like(x)
    rc = build.library().rt_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, float(eps),
        build.DTYPE_CODE[x.dtype], build.stream_of(x))
    build.check(rc, what)
    global launches
    launches += 1
    return y
