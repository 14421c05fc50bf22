"""Wrapper of the CUDA Shared-RMSProp update (``csrc/rmsprop.cu``).

Replaces ``repro/kernels/shared_rmsprop.py::rmsprop_update_2d`` together
with the lane padding of the JAX ``dispatch.rmsprop_update``: the kernel
takes a flat leaf of any size.  A CUDA tensor launches the kernel (or
raises); a CPU tensor takes ``ref.rmsprop_update_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0    # kernel launches since the last reset (dispatch.reset_...)


def rmsprop_update(g: torch.Tensor, grad: torch.Tensor, *, lr: float,
                   alpha: float = 0.99, eps: float = 0.1):
    """Paper Eq. 8-9 for one f32 leaf of any shape.  Writes
    g' = alpha * g + (1 - alpha) * grad^2 over ``g`` (in place, on both
    devices) and returns (g, update), update = lr * grad / sqrt(g' + eps).
    ``lr`` is a host float: nothing waits on the device."""
    what = "rmsprop_update"
    build.require(g.shape == grad.shape, what,
                  f"g {tuple(g.shape)} and grad {tuple(grad.shape)} differ")
    build.require(g.dtype == torch.float32 and grad.dtype == torch.float32,
                  what, f"dtypes g {g.dtype}, grad {grad.dtype} (want "
                  "float32)")
    build.require(g.device == grad.device, what,
                  f"g on {g.device}, grad on {grad.device}")
    if g.device.type == "cpu":
        new_g, upd = ref.rmsprop_update_ref(g, grad, lr=lr, alpha=alpha,
                                            eps=eps)
        return g.copy_(new_g), upd
    build.require(g.is_cuda, what, f"unsupported device {g.device}")
    build.require(g.is_contiguous() and grad.is_contiguous(), what,
                  "inputs must be contiguous")
    build.require(g.data_ptr() % 16 == 0 and grad.data_ptr() % 16 == 0, what,
                  "inputs must start on 16-byte boundaries (the kernel "
                  "moves 16 bytes at a time)")
    upd = torch.empty_like(grad)
    rc = build.library().rt_rmsprop_update(
        g.data_ptr(), grad.data_ptr(), g.data_ptr(), upd.data_ptr(),
        g.numel(), float(lr), float(alpha), float(1.0 - alpha), float(eps),
        build.stream_of(g))
    build.check(rc, what)
    global launches
    launches += 1
    return g, upd
