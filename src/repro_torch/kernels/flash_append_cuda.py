"""Wrapper of the CUDA append-mode flash attention (``csrc/flash_append.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_append``,
over an f32, bf16 or int8 key stream (int8 with (B, Sk, Hkv, 1) f32
scales).  A CUDA tensor launches the kernel (or raises); a CPU tensor takes
``ref.flash_attention_append_ref`` (or its quant version).  The kernel
masks its own ragged edges, so any chunk length and key-stream length stay
on the kernel.

Four arms, each counted apart.  A bf16 q over a bf16 key stream runs on
the tensor cores (``append_mma_kernel<D, Bf16Stream>``; p rounded to bf16
before P V, as the TPU kernel does, so it meets its plain version within
``ref.ROUND_TOL`` times ``ref.append_round_scale``).  A bf16 q over an
int8 stream runs the same tile loop (``append_mma_kernel<D,
Int8Stream>``): the int8 tiles are widened to bf16 in shared memory
(exact), the scores scaled by each key's k scale, and p times each key's
v scale split into two bf16 terms for two P V products, so it keeps the
reference's unrounded f32 p to about 2**-17 (``ref.append_int8_mma_ref``
models it) and meets the plain version at the int8 tolerance.  Any f32
operand over a float stream runs the exact SIMT body, and an f32 q over
an int8 stream its int8 arm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (dispatch.reset_launch_counts), by arm
launches = 0            # bf16 q and key stream: tensor cores
f32_launches = 0        # q or key stream f32: SIMT
int8_launches = 0       # bf16 q, int8 key stream: tensor cores
int8_f32_launches = 0   # f32 q, int8 key stream: SIMT

HEAD_DIMS = (64, 128)   # head dims the kernel is instantiated for


def flash_attention_append(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kpos: torch.Tensor, *, pos0: int,
                           window: Optional[int] = None,
                           kpos_linear: bool = False, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q (B,C,Hq,D) at absolute positions pos0 + i; k,v (B,Sk,Hkv,D) the
    key stream (f32, bf16, or int8 with (B,Sk,Hkv,1) f32 ``k_scale`` /
    ``v_scale``); kpos (B,Sk) int32 (-1 = invalid) -> (B,C,Hq,D) in q's
    dtype.  ``kpos_linear`` asserts key row index == absolute position
    wherever valid and enables the dead-tile skip."""
    what = "flash_attention_append"
    build.require(q.dim() == 4 and k.dim() == 4, what,
                  f"want q (B,C,Hq,D) and k (B,Sk,Hkv,D), got "
                  f"{tuple(q.shape)} / {tuple(k.shape)}")
    b, c, hq, d = q.shape
    _, sk, hkv, dk = k.shape
    build.require(k.shape[0] == b and dk == d and v.shape == k.shape, what,
                  f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                  f"{tuple(q.shape)}")
    build.require(hq % hkv == 0, what,
                  f"GQA needs q heads to be a multiple of kv heads, got "
                  f"{hq}/{hkv}")
    build.require(tuple(kpos.shape) == (b, sk) and kpos.dtype == torch.int32,
                  what, f"want kpos (B,Sk) int32, got {tuple(kpos.shape)} "
                  f"{kpos.dtype}")
    build.require(q.dtype in build.DTYPE_CODE and
                  k.dtype in build.KV_DTYPE_CODE and v.dtype == k.dtype, what,
                  f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} (want q "
                  "float32 or bfloat16, k and v float32, bfloat16 or int8, "
                  "alike)")
    quant = k.dtype == torch.int8
    build.require((k_scale is not None) == quant and
                  (v_scale is not None) == quant, what,
                  "an int8 key stream needs k_scale and v_scale, a float one "
                  "takes none")
    scales = ()
    if quant:
        build.require(k_scale.shape == (b, sk, hkv, 1) and
                      v_scale.shape == k_scale.shape and
                      k_scale.dtype == torch.float32 and
                      v_scale.dtype == torch.float32, what,
                      f"want f32 scales {(b, sk, hkv, 1)}, got "
                      f"{tuple(k_scale.shape)} {k_scale.dtype} / "
                      f"{tuple(v_scale.shape)} {v_scale.dtype}")
        scales = (k_scale, v_scale)
    build.require(pos0 >= 0 and (window is None or window > 0), what,
                  f"pos0={pos0}, window={window}")
    tensors = (q, k, v, kpos) + scales
    build.require(len({t.device for t in tensors}) == 1, what,
                  "inputs on different devices")
    if q.device.type == "cpu":
        if quant:
            return ref.flash_attention_append_quant_ref(
                q, k, v, k_scale, v_scale, kpos, pos0=pos0, window=window)
        return ref.flash_attention_append_ref(q, k, v, kpos, pos0=pos0,
                                              window=window)
    build.require(q.is_cuda, what, f"unsupported device {q.device}")
    build.require(d in HEAD_DIMS, what, f"head dim {d} not in {HEAD_DIMS}")
    build.require(all(t.is_contiguous() for t in tensors), what,
                  "inputs must be contiguous")
    build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), what,
                  "q, k and v must start on 16-byte boundaries (the kernel "
                  "loads 16 bytes at a time)")
    out = torch.empty_like(q)
    rc = build.library().rt_flash_append_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, kpos.data_ptr(),
        out.data_ptr(), b, c, sk, hq, hkv, d, int(pos0),
        int(window) if window is not None else 0, int(bool(kpos_linear)),
        build.DTYPE_CODE[q.dtype], build.KV_DTYPE_CODE[k.dtype],
        build.stream_of(q))
    build.check(rc, what)
    global launches, f32_launches, int8_launches, int8_f32_launches
    if quant and q.dtype == torch.bfloat16:
        int8_launches += 1
    elif quant:
        int8_f32_launches += 1
    elif q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16:
        launches += 1
    else:
        f32_launches += 1
    return out
