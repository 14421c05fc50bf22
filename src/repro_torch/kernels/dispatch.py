"""Kernel dispatch: the model layer's single entry to the kernels.

Counterpart of ``repro/kernels/dispatch.py`` for the ops on the serving
and training paths.  Routing is by the tensor's device: a CUDA tensor goes
to the hand-written kernel, a CPU tensor to its plain PyTorch version (the
wrappers make that choice, on the device alone).  There is no alignment
arm: the JAX dispatch's 128-multiple fallbacks exist for the TPU's tiles,
while these kernels mask their own ragged edges, so a CUDA call never
falls back.  What stays from the JAX layer is the per-slot normalisation
of the decode call (scalar ``pos`` and 1-D ``kpos`` broadcast, ``pos=None``
meaning ``max(kpos)``), the GQA check, the context-parallel decode (the
partials kernel over the local cache slice, then the (m, l, acc) combine
across ranks: ``jax.lax.pmax``/``psum`` there, two counted all-reduces
here), and the custom gradients of ``flash_attention`` and ``rmsnorm``
(``jax.custom_vjp`` there, a ``torch.autograd.Function`` here, the same on
both devices) whose backwards are kernels too.  Int8 KV caches pass their
(..., Hkv, 1) f32 scales to the decode and append kernels, which
dequantise inside.  The paged arms (``decode_attention_paged``,
``flash_attention_append_paged``) gather a page pool into the dense view
through its page table, as the JAX arms do, and delegate to the decode
and append kernels.  The speculative verify arms (``flash_attention_verify``
and its paged form) re-base each row's key positions so that a ragged
batch of draft chunks is one append call at a static ``pos0``.

Each wrapper counts its launches, by kernel and arm; ``launch_counts`` /
``reset_launch_counts`` read and clear them, so a run can show that its
main path went through the kernels.  The verify arms keep route counts
beside them (``route_counts``: ``flash_verify``, ``verify_paged``), the
calls that reached the append kernel through them, which the kernel
counts again as its own; the model layer counts there which MoE it took
(``moe_ep``, ``moe_dense``) and, under tensor and sequence parallelism,
its attention calls on local heads (``tp_heads``; ``tp_kv_whole`` where
the kv heads are taken from whole leaves), its norms on the
sequence-parallel rows (``sp_rows``), its recurrent blocks on local heads
(``tp_ssm_heads`` for mamba2, ``tp_lstm_heads`` for mLSTM and sLSTM),
its norms on rows gathered along the features (``tp_feature_rows``) and
its cross attention on local heads (``tp_cross``), and under the serving
layout its decode attention on gathered heads (``tp_decode_heads``) and
its dense MoE on this rank's experts (``tp_experts_local``): the kernels
see local tensors and need no arm of their own.  ``reset_launch_counts`` clears both.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed import collectives, sharding
from repro_torch.kernels import (decode_attention_cuda, flash_append_cuda,
                                 flash_attention_bwd_cuda,
                                 flash_attention_cuda, ref, rmsnorm_cuda,
                                 rmsprop_cuda)

# op -> (wrapper module, its counter)
_COUNTERS = {
    "rmsnorm": (rmsnorm_cuda, "launches"),
    "rmsnorm_bwd": (rmsnorm_cuda, "bwd_launches"),
    "flash_append": (flash_append_cuda, "launches"),
    "flash_append_f32": (flash_append_cuda, "f32_launches"),
    "flash_append_int8": (flash_append_cuda, "int8_launches"),
    "flash_append_int8_f32": (flash_append_cuda, "int8_f32_launches"),
    "decode_attention": (decode_attention_cuda, "launches"),
    "decode_attention_int8": (decode_attention_cuda, "int8_launches"),
    "decode_attention_partials": (decode_attention_cuda, "partials_launches"),
    "decode_attention_partials_int8": (decode_attention_cuda,
                                       "partials_int8_launches"),
    "flash_attention": (flash_attention_cuda, "launches"),
    "flash_attention_f32": (flash_attention_cuda, "f32_launches"),
    "flash_attention_bwd": (flash_attention_bwd_cuda, "launches"),
    "flash_attention_bwd_f32": (flash_attention_bwd_cuda, "f32_launches"),
    "rmsprop": (rmsprop_cuda, "launches"),
    "rmsprop_update_multi": (rmsprop_cuda, "multi_launches"),
    "rmsprop_apply_multi": (rmsprop_cuda, "apply_launches")}
# route -> calls since the last reset (not kernels: each verify call is
# counted again by the append kernel's arm that it launches; the MoE
# routes and the tensor-parallel ones are the model layer's, which it
# counts here with count_route)
_ROUTES = {"flash_verify": 0, "verify_paged": 0, "moe_ep": 0,
           "moe_dense": 0, "tp_heads": 0, "tp_kv_whole": 0, "sp_rows": 0,
           "tp_ssm_heads": 0, "tp_lstm_heads": 0, "tp_feature_rows": 0,
           "tp_cross": 0, "tp_decode_heads": 0, "tp_experts_local": 0}


def launch_counts() -> Dict[str, int]:
    return {op: getattr(mod, name) for op, (mod, name) in _COUNTERS.items()}


def route_counts() -> Dict[str, int]:
    return dict(_ROUTES)


def count_route(route: str) -> None:
    _ROUTES[route] += 1


def reset_launch_counts() -> None:
    for mod, name in _COUNTERS.values():
        setattr(mod, name, 0)
    for route in _ROUTES:
        _ROUTES[route] = 0


def _check_gqa(hq: int, hkv: int) -> None:
    if hq % hkv != 0:
        raise ValueError(f"GQA needs q heads to be a multiple of kv heads, "
                         f"got {hq}/{hkv}")


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with the one-pass backward: the forward saves rstd, the
    backward kernel returns dx and dscale (JAX ``dispatch.py:980-1011``)."""

    @staticmethod
    def forward(ctx, x2, scale, eps):
        y, rstd = rmsnorm_cuda.rmsnorm_fwd(x2, scale, eps=eps,
                                           save_residuals=True)
        ctx.save_for_backward(x2, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_cuda.rmsnorm_bwd(x2, scale, rstd,
                                              dy.contiguous())
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm over the last dim of an activation of any rank.
    Differentiable: where a gradient is wanted the forward keeps rstd and
    the backward runs the rmsnorm backward kernel."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        y = _RMSNorm.apply(x2, scale, eps)
    else:
        y = rmsnorm_cuda.rmsnorm_fwd(x2, scale, eps=eps)
    return y.reshape(shape)


class _FlashAttention(torch.autograd.Function):
    """Training attention: the forward kernel saves the per-row lse, the
    backward kernel pair rebuilds p from it (JAX ``dispatch.py:201-228``,
    residuals (q, k, v, o, lse))."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_cuda.flash_attention_fwd(
            q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,Hq,D); k,v (B,S,Hkv,D) -> (B,S,Hq,D): full-sequence causal
    (or bidirectional, ``causal=False``) attention with an optional sliding
    window.  Differentiable through the forward and backward kernels."""
    _check_gqa(q.shape[2], k.shape[2])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window)


def rmsprop_update(g: torch.Tensor, grad: torch.Tensor, *, lr: float,
                   alpha: float = 0.99, eps: float = 0.1):
    """Fused Shared-RMSProp (paper Eq. 8-9) for a parameter leaf of any
    shape and size.  Writes the new accumulator over ``g`` (in place) and
    returns (new_g, update); the caller subtracts update."""
    return rmsprop_cuda.rmsprop_update(g, grad.contiguous(), lr=lr,
                                       alpha=alpha, eps=eps)


def rmsprop_update_multi(gs, grads, *, lr: float, alpha: float = 0.99,
                         eps: float = 0.1):
    """``rmsprop_update`` over lists of leaves, one launch for up to
    ``rmsprop_cuda.MAX_LEAVES`` of them: g' over each ``gs`` leaf; returns
    the updates."""
    return rmsprop_cuda.rmsprop_update_multi(
        gs, [d.contiguous() for d in grads], lr=lr, alpha=alpha, eps=eps)


def rmsprop_apply_multi(params, gs, grads, *, lr: float, alpha: float = 0.99,
                        eps: float = 0.1) -> None:
    """One Shared-RMSProp step over lists of f32 leaves, in place: g' over
    ``gs`` and p - update over ``params``, the subtraction fused into the
    update kernel (one launch for up to ``rmsprop_cuda.MAX_LEAVES``
    leaves)."""
    rmsprop_cuda.rmsprop_apply_multi(
        params, gs, [d.contiguous() for d in grads], lr=lr, alpha=alpha,
        eps=eps)


def flash_attention_append(q, k, v, kpos, *, pos0: int,
                           window: Optional[int] = None,
                           kpos_linear: bool = False,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Append-mode attention for chunked prefill: q (B,C,Hq,D) at absolute
    positions pos0 + i; k,v (B,Sk,Hkv,D) the key stream (cache prefix +
    chunk; int8 with (B,Sk,Hkv,1) f32 ``k_scale``/``v_scale``); kpos (B,Sk)
    [or (Sk,), broadcast] absolute position per key row (-1 = invalid) ->
    (B,C,Hq,D).  ``kpos_linear`` asserts key row index == absolute position
    wherever valid (linear caches) and enables the dead-tile skip; ring
    layouts leave it False."""
    b, sk = q.shape[0], k.shape[1]
    _check_gqa(q.shape[2], k.shape[2])
    kpos = kpos.to(torch.int32).expand(b, sk).contiguous()
    return flash_append_cuda.flash_attention_append(
        q, k, v, kpos, pos0=pos0, window=window, kpos_linear=kpos_linear,
        k_scale=k_scale, v_scale=v_scale)


def decode_attention(q, k_cache, v_cache, kpos, pos=None, *,
                     k_scale=None, v_scale=None,
                     cp: Optional[sharding.DecodeCPSpec] = None
                     ) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D) (int8 with (B,L,Hkv,1) f32
    ``k_scale``/``v_scale``); kpos (B,L); pos (B,) -> (B,Hq,D).

    Positions are per batch slot; lockstep callers may pass kpos (L,) and
    a scalar pos, broadcast here to the per-slot layout.  ``pos=None``
    means each row's max(kpos).

    ``cp`` is the layout of a context-parallel cache slice, which the
    active ``decode_cp`` rules own (``models/attention.py`` passes it for a
    cache it laid out under them): the caches and kpos are this rank's
    ``cp.l_loc`` columns, the partials kernel runs over them and the ranks
    of ``cp.group`` combine (JAX ``dispatch.py::_decode_cp_call``)."""
    b, length = q.shape[0], k_cache.shape[1]
    _check_gqa(q.shape[1], k_cache.shape[2])
    if pos is None:
        if cp is not None:
            raise ValueError("context-parallel decode needs pos: max(kpos) "
                             "of one slice is not the row's position")
        pos = kpos.amax(dim=-1)
    pos = torch.as_tensor(pos, device=q.device)
    kpos = kpos.to(torch.int32).expand(b, length).contiguous()
    pos = pos.to(torch.int32).expand(b).contiguous()
    if cp is None:
        return decode_attention_cuda.decode_attention_fwd(
            q, k_cache, v_cache, kpos, pos, k_scale, v_scale)
    if length != cp.l_loc:
        raise ValueError(f"context-parallel decode: cache slice of {length} "
                         f"rows, the layout says {cp.l_loc}")
    acc, m, l = decode_attention_cuda.decode_attention_partials(
        q, k_cache, v_cache, kpos, pos, k_scale, v_scale)
    return combine_partials(acc, m, l, cp.group).to(q.dtype)


def decode_attention_paged(q, k_pool, v_pool, page_table, pos, *,
                           length: Optional[int] = None, k_scale=None,
                           v_scale=None, kpos=None, rows=None
                           ) -> torch.Tensor:
    """Paged-layout decode: q (B,Hq,D); pools (P,page_size,Hkv,D) (int8
    with (P,page_size,Hkv,1) f32 scale pools, gathered through the same
    table); page_table (B,M) int32 (-1 = unmapped, page 0 the sink); pos
    (B,) or scalar -> (B,Hq,D).

    Gathers the dense view, statically cut to ``length`` rows (M *
    page_size by default), and delegates to ``decode_attention``: with the
    contiguous layout's cache_len the kernel sees that layout's shapes, so
    its split plan and reduction order, and its result bit for bit, are
    the contiguous layout's.  ``kpos`` (the view's (B, length) positions,
    ``ref.paged_kpos_ref``) and ``rows`` (the gather's pool rows,
    ``ref.paged_rows``) may come precomputed: every layer of a step shares
    one page table."""
    length = page_table.shape[1] * k_pool.shape[1] if length is None \
        else length
    if kpos is None:
        kpos = ref.paged_kpos_ref(page_table, k_pool.shape[1])[:, :length]
    if rows is None:
        rows = ref.paged_rows(page_table)
    view = [None if t is None else ref.paged_view(t, page_table, length,
                                                  rows)
            for t in (k_pool, v_pool, k_scale, v_scale)]
    return decode_attention(q, view[0], view[1], kpos, pos,
                            k_scale=view[2], v_scale=view[3])


def flash_attention_append_paged(q, k_pool, v_pool, page_table, k_chunk,
                                 v_chunk, *, pos0: int, k_scale=None,
                                 v_scale=None, ks_chunk=None, vs_chunk=None,
                                 kpos=None, rows=None) -> torch.Tensor:
    """Paged-layout append for chunked prefill: q (B,C,Hq,D) at absolute
    positions pos0 + i; the pools hold the prefix [0, pos0) behind
    page_table (B,M); k_chunk/v_chunk (B,C,Hkv,D) the chunk's own K/V (an
    int8 pool takes them quantised, with ``ks_chunk``/``vs_chunk``, and
    its scale pools as ``k_scale``/``v_scale``).  At pos0 == 0 the pool is
    not read.  Linear layouts only: the gathered prefix keeps key row ==
    absolute position wherever mapped, so the delegated call runs with
    ``kpos_linear=True``; a float prefix is cast to q's dtype, as the
    contiguous layout's stream is.  ``kpos`` (the stream's,
    ``ref.append_paged_kpos``) and ``rows`` (``ref.paged_rows`` of the
    prefix's table) may come precomputed for all layers."""
    quant = k_scale is not None
    ps = k_pool.shape[1]
    pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
    chunks = (k_chunk, v_chunk) + ((ks_chunk, vs_chunk) if quant else ())
    stream = ref.append_paged_stream(pools, page_table, chunks, pos0, ps,
                                     cast=not quant, rows=rows)
    if kpos is None:
        kpos = ref.append_paged_kpos(page_table, ps, pos0, q.shape[1])
    scales = stream[2:] if quant else (None, None)
    return flash_attention_append(q, stream[0], stream[1], kpos, pos0=pos0,
                                  kpos_linear=True, k_scale=scales[0],
                                  v_scale=scales[1])


# Speculative verify: K drafted tokens of a slot are a K-row append chunk,
# except that each row sits at its own depth pos[j] while the append kernel
# takes one static pos0.  Its masks are relative (causal kpos <= qpos, the
# window kpos > qpos - window), so adding one constant to every key and
# query position of a row changes nothing: re-basing row j by
# shift - pos[j] (``shift`` a static bound on pos, the cache length) makes
# the batch one append call at pos0 = shift.  Key row index then no longer
# equals position, so the call runs with kpos_linear=False and visits every
# tile.  RoPE stays the model layer's, at the true positions.

def flash_attention_verify(q, k, v, kpos, *, pos, shift: int,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Speculative-verify attention (JAX ``dispatch.py:869``): q (B,K,Hq,D)
    row j's draft chunk at positions pos[j] + i; k,v (B,Sk,Hkv,D) the key
    stream (cache prefix + the chunk's own K/V; int8 with (B,Sk,Hkv,1) f32
    scales, which pass through untouched); kpos (B,Sk) [or (Sk,)] absolute
    positions (-1 invalid); pos (B,); ``shift`` >= every pos ->
    (B,K,Hq,D), through one ``flash_attention_append`` call."""
    b, sk = q.shape[0], k.shape[1]
    kpos = kpos.to(torch.int32).expand(b, sk)
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32).expand(b)
    kpos = torch.where(kpos >= 0, kpos - pos[:, None] + shift, -1)
    _ROUTES["flash_verify"] += 1
    return flash_attention_append(q, k, v, kpos, pos0=shift, window=window,
                                  kpos_linear=False, k_scale=k_scale,
                                  v_scale=v_scale)


def flash_attention_verify_paged(q, k_pool, v_pool, page_table, k_chunk,
                                 v_chunk, *, pos, length: int, k_scale=None,
                                 v_scale=None, ks_chunk=None, vs_chunk=None,
                                 kpos=None, rows=None) -> torch.Tensor:
    """Paged-layout verify (JAX ``dispatch.py:910``): q (B,K,Hq,D) at
    positions pos[j] + i; the pools hold the committed prefix behind
    page_table (B,M); k_chunk/v_chunk (B,K,Hkv,D) the chunk's own K/V, not
    in the pool (the commit comes after the accept decision; an int8 pool
    takes them quantised, with ``ks_chunk``/``vs_chunk``, and its scale
    pools as ``k_scale``/``v_scale``).  The view is cut to ``length`` rows
    and its kpos clamped below each row's pos: pages mapped ahead of the
    verify hold rows no commit wrote.  ``kpos`` (the stream's,
    ``ref.verify_paged_kpos``) and ``rows`` (``ref.paged_rows``) may come
    precomputed for all layers."""
    quant = k_scale is not None
    b, kq = q.shape[0], q.shape[1]
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32).expand(b)
    if kpos is None:
        kpos = ref.verify_paged_kpos(page_table, k_pool.shape[1], pos,
                                     length, kq)
    if rows is None:
        rows = ref.paged_rows(page_table)
    pools = (k_pool, v_pool) + ((k_scale, v_scale) if quant else ())
    chunks = (k_chunk, v_chunk) + ((ks_chunk, vs_chunk) if quant else ())
    stream = []
    for pool, chunk in zip(pools, chunks):
        pre = ref.paged_view(pool, page_table, length, rows)
        stream.append(torch.cat([pre if quant else pre.to(q.dtype),
                                 chunk], dim=1))
    scales = stream[2:] if quant else (None, None)
    _ROUTES["verify_paged"] += 1
    return flash_attention_verify(q, stream[0], stream[1], kpos, pos=pos,
                                  shift=length, k_scale=scales[0],
                                  v_scale=scales[1])


def combine_partials(acc, m, l, group) -> torch.Tensor:
    """o = sum(acc e^(m - max m)) / sum(l e^(m - max m)) over the ranks of
    ``group`` (``ref.combine_partials`` across processes): an all-reduce
    MAX of m, then one SUM of l and acc packed in one buffer, both counted
    (``collectives.counts``).  Every rank
    gets the same (B, Hq, D) f32 result."""
    m_max = collectives.max_over(m, group)
    corr = torch.exp(m - m_max)
    buf = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    collectives.all_reduce(buf, group)
    o = buf[..., 1:] / torch.clamp(buf[..., :1], min=ref.L_FLOOR)
    b, hkv, g, d = acc.shape
    return o.reshape(b, hkv * g, d)
