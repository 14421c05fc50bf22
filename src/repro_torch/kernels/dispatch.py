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
across ranks: ``jax.lax.pmax``/``psum`` there, two ``dist.all_reduce``s
here), and the custom gradients of ``flash_attention`` and ``rmsnorm``
(``jax.custom_vjp`` there, a ``torch.autograd.Function`` here, the same on
both devices) whose backwards are kernels too.  Int8 KV caches pass their
(..., Hkv, 1) f32 scales to the decode and append kernels, which
dequantise inside.

Each wrapper counts its launches, by kernel and arm; ``launch_counts`` /
``reset_launch_counts`` read and clear them, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding
from repro_torch.kernels import (decode_attention_cuda, flash_append_cuda,
                                 flash_attention_bwd_cuda,
                                 flash_attention_cuda, ref, rmsnorm_cuda,
                                 rmsprop_cuda)

# op -> (wrapper module, its counter)
_COUNTERS = {
    "rmsnorm": (rmsnorm_cuda, "launches"),
    "rmsnorm_bwd": (rmsnorm_cuda, "bwd_launches"),
    "flash_append": (flash_append_cuda, "launches"),
    "flash_append_int8": (flash_append_cuda, "int8_launches"),
    "decode_attention": (decode_attention_cuda, "launches"),
    "decode_attention_int8": (decode_attention_cuda, "int8_launches"),
    "decode_attention_partials": (decode_attention_cuda, "partials_launches"),
    "decode_attention_partials_int8": (decode_attention_cuda,
                                       "partials_int8_launches"),
    "flash_attention": (flash_attention_cuda, "launches"),
    "flash_attention_f32": (flash_attention_cuda, "f32_launches"),
    "flash_attention_bwd": (flash_attention_bwd_cuda, "launches"),
    "flash_attention_bwd_f32": (flash_attention_bwd_cuda, "f32_launches"),
    "rmsprop": (rmsprop_cuda, "launches")}


def launch_counts() -> Dict[str, int]:
    return {op: getattr(mod, name) for op, (mod, name) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, name in _COUNTERS.values():
        setattr(mod, name, 0)


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
    return _combine_partials(acc, m, l, cp.group).to(q.dtype)


def _combine_partials(acc, m, l, group) -> torch.Tensor:
    """o = sum(acc e^(m - max m)) / sum(l e^(m - max m)) over the ranks of
    ``group`` (``ref.combine_partials`` across processes): an all-reduce
    MAX of m, then one SUM of l and acc packed in one buffer.  Every rank
    gets the same (B, Hq, D) f32 result."""
    sharding.check_backend(group, acc.device)
    m_max = m.clone()
    dist.all_reduce(m_max, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_max)
    buf = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    o = buf[..., 1:] / torch.clamp(buf[..., :1], min=ref.L_FLOOR)
    b, hkv, g, d = acc.shape
    return o.reshape(b, hkv * g, d)
