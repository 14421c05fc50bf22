"""Wrapper of the CUDA per-slot decode attention
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_fwd``.  A
CUDA tensor launches the kernel (or raises); a CPU tensor takes
``ref.decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0    # kernel launches since the last reset (dispatch.reset_...)

HEAD_DIMS = (64, 128)   # head dims the kernel is instantiated for
MAX_GROUP = 16          # query heads per kv head one block holds


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kpos: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) int32; pos (B,) int32 ->
    (B,Hq,D) in q's dtype.  q and the caches may each be f32 or bf16."""
    what = "decode_attention_fwd"
    build.require(q.dim() == 3 and k_cache.dim() == 4, what,
                  f"want q (B,Hq,D) and caches (B,L,Hkv,D), got "
                  f"{tuple(q.shape)} / {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    _, length, hkv, dk = k_cache.shape
    build.require(k_cache.shape[0] == b and dk == d, what,
                  f"cache {tuple(k_cache.shape)} does not match q "
                  f"{tuple(q.shape)}")
    build.require(v_cache.shape == k_cache.shape, what,
                  "k and v caches differ in shape")
    build.require(hq % hkv == 0, what,
                  f"GQA needs q heads to be a multiple of kv heads, got "
                  f"{hq}/{hkv}")
    build.require(tuple(kpos.shape) == (b, length) and
                  tuple(pos.shape) == (b,), what,
                  f"want kpos (B,L) and pos (B,), got {tuple(kpos.shape)} "
                  f"/ {tuple(pos.shape)}")
    build.require(q.dtype in build.DTYPE_CODE and
                  k_cache.dtype in build.DTYPE_CODE and
                  v_cache.dtype == k_cache.dtype, what,
                  f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}"
                  " (want float32 or bfloat16, k and v alike)")
    build.require(kpos.dtype == torch.int32 and pos.dtype == torch.int32,
                  what, "kpos and pos must be int32")
    build.require(len({t.device for t in (q, k_cache, v_cache, kpos, pos)})
                  == 1, what, "inputs on different devices")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, kpos, pos)
    build.require(q.is_cuda, what, f"unsupported device {q.device}")
    build.require(d in HEAD_DIMS, what, f"head dim {d} not in {HEAD_DIMS}")
    build.require(hq // hkv <= MAX_GROUP, what,
                  f"{hq // hkv} query heads per kv head (max {MAX_GROUP})")
    build.require(all(t.is_contiguous()
                      for t in (q, k_cache, v_cache, kpos, pos)), what,
                  "inputs must be contiguous")
    build.require(all(t.data_ptr() % 16 == 0
                      for t in (q, k_cache, v_cache)), what,
                  "q, k and v must start on 16-byte boundaries (the kernel "
                  "loads 16 bytes at a time)")
    out = torch.empty_like(q)
    rc = build.library().rt_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kpos.data_ptr(), pos.data_ptr(), out.data_ptr(), b, length, hq, hkv,
        d, build.DTYPE_CODE[q.dtype], build.DTYPE_CODE[k_cache.dtype],
        build.stream_of(q))
    build.check(rc, what)
    global launches
    launches += 1
    return out
