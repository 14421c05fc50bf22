"""Wrapper of the CUDA flash-attention forward for training
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes
``ref.flash_attention_ref``.  The kernel masks its own ragged edges, so any
sequence length stays on the kernel.  It has two arms, chosen by dtype and
counted apart: bf16 runs on the tensor cores (``launches``), f32 on the
exact SIMT body (``f32_launches``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

launches = 0        # bf16 (tensor-core) launches since the last reset
f32_launches = 0    # f32 (SIMT) launches since the last reset

HEAD_DIMS = (64, 128)   # head dims the kernels are instantiated for


def check_train_inputs(what: str, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, window: Optional[int]) -> None:
    """Shape, dtype and device rules shared with the backward wrapper."""
    build.require(q.dim() == 4 and k.dim() == 4, what,
                  f"want q (B,S,Hq,D) and k (B,S,Hkv,D), got "
                  f"{tuple(q.shape)} / {tuple(k.shape)}")
    b, s, hq, d = q.shape
    build.require(k.shape[0] == b and k.shape[1] == s and k.shape[3] == d
                  and v.shape == k.shape, what,
                  f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                  f"{tuple(q.shape)}")
    build.require(hq % k.shape[2] == 0, what,
                  f"GQA needs q heads to be a multiple of kv heads, got "
                  f"{hq}/{k.shape[2]}")
    build.require(q.dtype in build.DTYPE_CODE and k.dtype == q.dtype and
                  v.dtype == q.dtype, what,
                  f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} (want one "
                  "of float32 or bfloat16 for all)")
    build.require(window is None or window > 0, what, f"window={window}")
    build.require(len({t.device for t in (q, k, v)}) == 1, what,
                  "inputs on different devices")


def check_card_inputs(what: str, *ts: torch.Tensor) -> None:
    q = ts[0]
    build.require(q.is_cuda, what, f"unsupported device {q.device}")
    build.require(q.shape[3] in HEAD_DIMS, what,
                  f"head dim {q.shape[3]} not in {HEAD_DIMS}")
    build.require(all(t.is_contiguous() for t in ts), what,
                  "inputs must be contiguous")
    build.require(all(t.data_ptr() % 16 == 0 for t in ts), what,
                  "inputs must start on 16-byte boundaries (the kernels "
                  "load 16 bytes at a time)")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None):
    """q (B,S,Hq,D); k, v (B,S,Hkv,D), one dtype -> (out (B,S,Hq,D), the
    per-row log-sum-exp (B,Hq,S) f32 that the backward needs)."""
    what = "flash_attention_fwd"
    check_train_inputs(what, q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    check_card_inputs(what, q, k, v)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    rc = build.library().rt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, hq, k.shape[2], d,
        int(bool(causal)), int(window) if window is not None else 0,
        build.DTYPE_CODE[q.dtype], build.stream_of(q))
    build.check(rc, what)
    global launches, f32_launches
    if q.dtype == torch.float32:
        f32_launches += 1
    else:
        launches += 1
    return out, lse
