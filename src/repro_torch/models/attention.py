"""Grouped-query attention with RoPE, sliding windows and KV caches.

Counterpart of ``repro/models/attention.py`` for the training path and,
on the contiguous cache layout, the serving path:

  * ``attend_train``   — full-sequence causal (or bidirectional) attention
    through the differentiable flash kernels;
  * ``attend_decode``  — one new token per slot against its KV cache;
  * ``attend_prefill`` — one prompt chunk, written into the cache and
    attended through the append kernel.

Caches are updated in place (the JAX functions return new caches; here the
same dict comes back with its tensors written), which keeps one copy of
each cache on the card.  The paged layout and int8 caches are later
slices and raise; the context-parallel decode comes with multi-GPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch, kv_quant
from repro_torch.models import common as cm

_PAGED_ITEM = ("see ROADMAP.md, queue 1, slice 3: paged KV, int8 KV and "
               "speculative serving")


def attention_shapes(d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, *, qkv_bias: bool = False) -> dict:
    def lin(d_in, d_out, bias):
        p = {"w": (d_in, d_out)}
        if bias:
            p["b"] = (d_out,)
        return p
    return {"wq": lin(d_model, n_heads * head_dim, qkv_bias),
            "wk": lin(d_model, n_kv_heads * head_dim, qkv_bias),
            "wv": lin(d_model, n_kv_heads * head_dim, qkv_bias),
            "wo": lin(n_heads * head_dim, d_model, False)}


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Cache for one attention layer: ``k``/``v`` (batch, cache_len, Hkv,
    D).  The JAX cache's ``index`` leaf is written but never read there, so
    the port keeps no counterpart."""
    if kv_quant.is_quantized(dtype):
        raise NotImplementedError(f"int8 KV caches are not ported yet "
                                  f"({kv_quant.INT8_ITEM})")
    shape = (batch, cache_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _check_layout(cache: dict) -> None:
    if "kp" in cache:
        raise NotImplementedError(f"paged KV caches are not ported yet "
                                  f"({_PAGED_ITEM})")


def _qkv(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    n_h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(cm.linear(params["wq"], x), n_h, hd)
    k = _split_heads(cm.linear(params["wk"], x), n_kv, hd)
    v = _split_heads(cm.linear(params["wv"], x), n_kv, hd)
    cos, sin = cm.rope_cos_sin(positions, hd, cfg.rope_theta)
    q = cm.apply_rope(q, cos, sin, rotary_dim=cfg.rotary_dim)
    k = cm.apply_rope(k, cos, sin, rotary_dim=cfg.rotary_dim)
    return q, k, v


def attend_train(params: dict, x: torch.Tensor, cfg, *,
                 window: Optional[int] = None,
                 bidirectional: bool = False) -> torch.Tensor:
    """Full-sequence self attention.  x (B, S, d_model) at positions
    0 .. S-1 -> (B, S, d_model)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None]          # (1, S)
    q, k, v = _qkv(params, x, cfg, positions)
    o = dispatch.flash_attention(q, k, v, causal=not bidirectional,
                                 window=window)
    return cm.linear(params["wo"], o.reshape(b, s, cfg.n_heads * cfg.hd))


def attend_decode(params: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor, cfg, *, window: Optional[int] = None):
    """One-token decode.  x (B, 1, d_model); pos the absolute position, a
    lockstep scalar () or per slot (B,) (every row decodes at its own
    depth: writes, RoPE and the validity mask are per row).

    Writes row ``pos % cache_len`` of each slot in place and returns
    (out (B, 1, d_model), cache).  With ``window`` the cache is a ring of
    length == window; otherwise cache_len covers every position."""
    _check_layout(cache)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).expand(b)
    q, k, v = _qkv(params, x, cfg, pos[:, None])
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % cache_len).long()
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    kpos = _cache_positions(cache_len, pos, window)
    o = dispatch.decode_attention(q[:, 0], ck, cv, kpos, pos)[:, None]
    n = cfg.n_heads * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, 1, n)), cache


def _cache_positions(cache_len: int, pos: torch.Tensor,
                     window: Optional[int]) -> torch.Tensor:
    """Absolute position of each cache slot; -1 for not-yet-written slots.
    pos () -> (L,); per-slot pos (B,) -> (B, L)."""
    pos = torch.as_tensor(pos)
    idx = torch.arange(cache_len, device=pos.device)
    if pos.dim() == 1:
        pos = pos[:, None]
    if window is None:
        return torch.where(idx <= pos, idx, -1)
    # ring buffer: slot s holds position p iff p % cache_len == s and
    # pos - cache_len < p <= pos
    cand = pos - (pos % cache_len) + idx
    cand = torch.where(cand > pos, cand - cache_len, cand)
    return torch.where(cand >= 0, cand, -1)


def attend_prefill(params: dict, x: torch.Tensor, cache: dict, pos0: int,
                   cfg, *, window: Optional[int] = None,
                   true_len: Optional[torch.Tensor] = None):
    """Prefill one prompt chunk.  x (B, C, d_model) covers absolute
    positions [pos0, pos0 + C), the same for every row (prompts are
    right-padded; ``true_len`` (B,) carries each row's real length so ring
    writes skip padding).

    Writes the chunk's K/V into cache rows [pos0, pos0 + C) (ring wrap for
    window caches) and runs one append-attention call: the chunk's queries
    against the key stream made of the cache prefix and the chunk's own
    K/V.  Returns (out (B, C, d_model), cache)."""
    _check_layout(cache)
    b, c, _ = x.shape
    positions = pos0 + torch.arange(c, device=x.device)[None]   # (1, C)
    q, k, v = _qkv(params, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]

    # key stream, taken from the cache as it was before this chunk's write
    # (a ring write below may overwrite rows the stream still needs)
    if pos0 == 0:
        k_all, v_all = k, v
        kpos_all = torch.arange(c, device=x.device)
        linear = True
    elif window is None:
        k_all = torch.cat([ck[:, :pos0].to(q.dtype), k], dim=1)
        v_all = torch.cat([cv[:, :pos0].to(q.dtype), v], dim=1)
        kpos_all = torch.arange(pos0 + c, device=x.device)
        linear = True
    else:
        k_all = torch.cat([ck.to(q.dtype), k], dim=1)
        v_all = torch.cat([cv.to(q.dtype), v], dim=1)
        kpos_pre = _cache_positions(
            cache_len, torch.tensor(pos0 - 1, device=x.device), window)
        kpos_all = torch.cat([kpos_pre, positions[0]])
        linear = False

    if window is None:
        if pos0 + c > cache_len:
            # a full cache has no wrap: writing past its end would clobber
            # real prompt rows that kpos still reports as valid
            raise ValueError(
                f"prefill chunk [{pos0}, {pos0 + c}) overflows the "
                f"{cache_len}-slot full cache; chunk the prompt to fit")
        ck[:, pos0:pos0 + c] = k.to(ck.dtype)
        cv[:, pos0:pos0 + c] = v.to(cv.dtype)
    else:
        # ring cache: slot s ends up holding the LAST written position
        # p == s (mod cache_len) with pos0 <= p < end[row], as a per-slot
        # gather (no duplicate-index hazard when C > cache_len; rows stop
        # at their real prompt length)
        end = torch.full((b,), pos0 + c, device=x.device)
        if true_len is not None:
            end = torch.minimum(end, true_len.to(end.device, end.dtype))
        idx = torch.arange(cache_len, device=x.device)
        last = end[:, None] - 1                                 # (B, 1)
        p_cand = last - ((last - idx[None, :]) % cache_len)     # (B, L)
        valid = (p_cand >= pos0)[:, :, None, None]
        sel = (p_cand - pos0).clamp(0, c - 1)[:, :, None, None] \
            .expand(b, cache_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.where(valid, torch.gather(k.to(ck.dtype), 1, sel),
                                 ck)
        cache["v"] = torch.where(valid, torch.gather(v.to(cv.dtype), 1, sel),
                                 cv)

    o = dispatch.flash_attention_append(q, k_all, v_all, kpos_all, pos0=pos0,
                                        window=window, kpos_linear=linear)
    n = cfg.n_heads * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, c, n)), cache
