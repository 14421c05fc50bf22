"""Wrapper of the CUDA per-slot decode attention
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_fwd`` and
``::decode_attention_partials``: one kernel body, normalised or as
flash-decoding partials, over f32, bf16 or int8 caches (int8 with
(B, L, Hkv, 1) f32 scales).  A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain versions in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (dispatch.reset_launch_counts), by arm
launches = 0                  # normalised, f32 / bf16 cache
int8_launches = 0             # normalised, int8 cache
partials_launches = 0         # partials, f32 / bf16 cache
partials_int8_launches = 0    # partials, int8 cache

HEAD_DIMS = (64, 128)   # head dims the kernel is instantiated for
MAX_GROUP = 16          # query heads per kv head one block holds


def _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale) -> None:
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
                  k_cache.dtype in build.KV_DTYPE_CODE and
                  v_cache.dtype == k_cache.dtype, what,
                  f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}"
                  " (want q float32 or bfloat16, caches float32, bfloat16 or "
                  "int8, k and v alike)")
    quant = k_cache.dtype == torch.int8
    build.require((k_scale is not None) == quant and
                  (v_scale is not None) == quant, what,
                  "int8 caches need k_scale and v_scale, float caches take "
                  "none")
    scales = ()
    if quant:
        build.require(k_scale.shape == (b, length, hkv, 1) and
                      v_scale.shape == k_scale.shape and
                      k_scale.dtype == torch.float32 and
                      v_scale.dtype == torch.float32, what,
                      f"want f32 scales {(b, length, hkv, 1)}, got "
                      f"{tuple(k_scale.shape)} {k_scale.dtype} / "
                      f"{tuple(v_scale.shape)} {v_scale.dtype}")
        scales = (k_scale, v_scale)
    build.require(kpos.dtype == torch.int32 and pos.dtype == torch.int32,
                  what, "kpos and pos must be int32")
    tensors = (q, k_cache, v_cache, kpos, pos) + scales
    build.require(len({t.device for t in tensors}) == 1, what,
                  "inputs on different devices")
    if q.device.type == "cpu":
        return
    build.require(q.is_cuda, what, f"unsupported device {q.device}")
    build.require(d in HEAD_DIMS, what, f"head dim {d} not in {HEAD_DIMS}")
    build.require(hq // hkv <= MAX_GROUP, what,
                  f"{hq // hkv} query heads per kv head (max {MAX_GROUP})")
    build.require(all(t.is_contiguous() for t in tensors), what,
                  "inputs must be contiguous")
    build.require(all(t.data_ptr() % 16 == 0
                      for t in (q, k_cache, v_cache)), what,
                  "q, k and v must start on 16-byte boundaries (the kernel "
                  "loads 16 bytes at a time)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kpos: torch.Tensor,
                         pos: torch.Tensor, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) int32; pos (B,) int32 ->
    (B,Hq,D) in q's dtype.  q may be f32 or bf16, the caches f32, bf16 or
    int8 with (B,L,Hkv,1) f32 ``k_scale``/``v_scale``."""
    what = "decode_attention_fwd"
    _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale)
    if q.device.type == "cpu":
        if k_scale is not None:
            return ref.decode_attention_quant_ref(q, k_cache, v_cache,
                                                  k_scale, v_scale, kpos, pos)
        return ref.decode_attention_ref(q, k_cache, v_cache, kpos, pos)
    b, hq, d = q.shape
    _, length, hkv, _ = k_cache.shape
    out = torch.empty_like(q)
    rc = build.library().rt_decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), kpos.data_ptr(), pos.data_ptr(), out.data_ptr(), b,
        length, hq, hkv, d, build.DTYPE_CODE[q.dtype],
        build.KV_DTYPE_CODE[k_cache.dtype], build.stream_of(q))
    build.check(rc, what)
    global launches, int8_launches
    if k_scale is None:
        launches += 1
    else:
        int8_launches += 1
    return out


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, kpos: torch.Tensor,
                              pos: torch.Tensor, k_scale=None, v_scale=None):
    """The inputs of ``decode_attention_fwd`` over a (local) cache slice ->
    its unnormalised online-softmax state (acc (B,Hkv,G,D), m (B,Hkv,G),
    l (B,Hkv,G)), all f32; ``ref.combine_partials`` (or the collective
    combine in ``dispatch``) turns slices into the attention output."""
    what = "decode_attention_partials"
    _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale)
    if q.device.type == "cpu":
        return ref.decode_attention_partials_ref(q, k_cache, v_cache, kpos,
                                                 pos, k_scale, v_scale)
    b, hq, d = q.shape
    _, length, hkv, _ = k_cache.shape
    g = hq // hkv
    acc = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = build.library().rt_decode_attention_partials(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), kpos.data_ptr(), pos.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, length, hq, hkv, d,
        build.DTYPE_CODE[q.dtype], build.KV_DTYPE_CODE[k_cache.dtype],
        build.stream_of(q))
    build.check(rc, what)
    global partials_launches, partials_int8_launches
    if k_scale is None:
        partials_launches += 1
    else:
        partials_int8_launches += 1
    return acc, m, l
