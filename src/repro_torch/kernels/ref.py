"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro/kernels/ref.py``'s oracles (and of the backward
formulas of ``repro/kernels/{rmsnorm,flash_attention_bwd}.py``), written
in PyTorch with the same arithmetic: f32 math, the finite ``NEG`` mask and
grouped query heads that never repeat the kv heads.  The CPU path of every
kernel wrapper runs these, and ``chip_smoke.py`` holds each CUDA kernel to
them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import kv_quant

NEG = -1e30
L_FLOOR = 1e-30     # floor on the softmax denominator (never a division by 0)

# The rounding of the bf16 flash kernels against these f32 plain versions.
# The TPU kernels, and the bf16 arms of the CUDA flash kernels, round p
# (forward; dv in the backward) and ds (dq, dk) once to bf16 before a
# product.  Each rounded factor is off by at most 2**-9 of itself (the bf16
# unit roundoff), so an output that sums such terms is off by at most 2**-9
# of the same sum over absolute values (``flash_round_scale``); ROUND_TOL
# is a factor of 2 above that bound, for the f32 sums around it.  lse is
# never rounded and keeps the f32 tolerance.
ROUND_TOL = 2.0 ** -8


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6, save_residuals: bool = False):
    """y = x * rsqrt(mean(x^2) + eps) * scale in f32, cast to x's dtype.
    With ``save_residuals`` also the per-row rsqrt(mean(x^2) + eps), f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf * rstd * scale).to(x.dtype)
    return (y, rstd[..., 0]) if save_residuals else y


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                    dy: torch.Tensor):
    """The one-pass RMSNorm backward (``rmsnorm.py::_bwd_kernel``): x, dy
    (rows, d); scale (d,); rstd (rows,) f32 -> (dx (rows, d) in x's dtype,
    dscale (d,) f32)."""
    xf, dyf = x.float(), dy.float()
    r = rstd[:, None]
    dys = dyf * scale
    c = (dys * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    dx = ((dys - xf * (r * r) * c) * r).to(x.dtype)
    return dx, (dyf * xf * r).sum(dim=0)


def rmsprop_update_ref(g: torch.Tensor, grad: torch.Tensor, *, lr: float,
                       alpha: float = 0.99, eps: float = 0.1):
    """Paper Eq. 8-9 (non-centred RMSProp with shared statistics), f32:
    returns (new_g, update); the caller subtracts update."""
    new_g = alpha * g + (1.0 - alpha) * grad.square()
    return new_g, lr * grad / torch.sqrt(new_g + eps)


def _train_mask(s: int, causal: bool, window: Optional[int], device):
    """(S, S) validity of key t for query s, positions = row indices."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _train_logits(q, k, causal: bool, window: Optional[int]):
    """Masked, scaled f32 scores (B, S, Hkv, G, S) of the grouped heads."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) * d ** -0.5
    mask = _train_mask(s, causal, window, q.device)
    return torch.where(mask[None, :, None, None, :], logits, NEG)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """q (B,S,Hq,D); k,v (B,S,Hkv,D) -> (out (B,S,Hq,D), lse (B,Hq,S) f32):
    softmax in f32, and the per-row log-sum-exp of the masked scores, the
    statistic the backward rebuilds p from."""
    b, s, hq, d = q.shape
    logits = _train_logits(q, k, causal, window)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    o = o.reshape(b, s, hq, d).to(q.dtype).contiguous()
    lse = torch.logsumexp(logits, dim=-1).reshape(b, s, hq).transpose(1, 2)
    return o, lse.contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None):
    """FlashAttention-2 backward from the saved lse, with the formulas of
    ``flash_attention_bwd.py``: p = exp(s - lse), delta = rowsum(do * o),
    ds = p * (dp - delta) * scale.  p and ds stay in f32: this is the exact
    yardstick.  The TPU kernel and the CUDA kernel's bf16 arm round them to
    bf16 before their products (the f32 arm does not); ``ROUND_TOL`` times
    ``flash_round_scale`` bounds what that rounding moves.  Returns (dq, dk,
    dv) in the input dtypes, dk and dv summed over each kv head's G query
    heads."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    logits = _train_logits(q, k, causal, window)          # (B,S,Hkv,G,S)
    lse_g = lse.transpose(1, 2).reshape(b, s, hkv, g, 1)
    p = torch.exp(logits - lse_g)
    dog = do.reshape(b, s, hkv, g, d).float()
    delta = (dog * o.reshape(b, s, hkv, g, d).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float())
    ds = p * (dp - delta) * scale
    qg = q.reshape(b, s, hkv, g, d).float()
    dq = torch.einsum("bshgt,bthd->bshgd", ds, k.float()).reshape(b, s, hq, d)
    dk = torch.einsum("bshgt,bshgd->bthd", ds, qg)
    dv = torch.einsum("bshgt,bshgd->bthd", p, dog)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def flash_round_scale(q, k, v, o, lse, do=None, causal: bool = True,
                      window: Optional[int] = None):
    """The sums over absolute terms that bound the bf16 rounding of p and ds
    (``ROUND_TOL``), from the true (f32) p and ds of the plain versions:
    sum_j p_ij |v_j| for o, and with ``do`` also sum_j |ds_ij| |k_j| for dq,
    sum_i |ds_ij| |q_i| for dk and sum_i p_ij |do_i| for dv (dk and dv
    summed over each kv head's query heads).  o and lse are the plain
    forward's.  Returns (o, dq, dk, dv) scales in f32 (the last three None
    without ``do``)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    logits = _train_logits(q, k, causal, window)          # (B,S,Hkv,G,S)
    p = torch.exp(logits - lse.transpose(1, 2).reshape(b, s, hkv, g, 1))
    o_s = torch.einsum("bshgt,bthd->bshgd", p,
                       v.float().abs()).reshape(b, s, hq, d)
    if do is None:
        return o_s, None, None, None
    dog = do.reshape(b, s, hkv, g, d).float()
    delta = (dog * o.reshape(b, s, hkv, g, d).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float())
    ds = (p * (dp - delta) * d ** -0.5).abs()
    qg = q.reshape(b, s, hkv, g, d).float().abs()
    dq_s = torch.einsum("bshgt,bthd->bshgd", ds,
                        k.float().abs()).reshape(b, s, hq, d)
    dk_s = torch.einsum("bshgt,bshgd->bthd", ds, qg)
    dv_s = torch.einsum("bshgt,bshgd->bthd", p, dog.abs())
    return o_s, dq_s, dk_s, dv_s


def _decode_logits(q, k_cache, kpos, pos):
    """Masked, scaled f32 scores (B, Hkv, G, L) of one query token per row
    against its cache; lockstep kpos (L,) and pos () broadcast."""
    b, hq, d = q.shape
    length, hkv = k_cache.shape[1], k_cache.shape[2]
    kpos = kpos.expand(b, length)
    pos = torch.as_tensor(pos, device=q.device).expand(b)
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    logits = torch.einsum("bhgd,blhd->bhgl", qg, k_cache.float()) * d ** -0.5
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    return torch.where(valid[:, None, None, :], logits, NEG)


def decode_attention_ref(q, k_cache, v_cache, kpos, pos) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) absolute position per slot
    (-1 = empty); pos (B,) current position per sequence -> (B,Hq,D).
    Lockstep shapes (kpos (L,), pos ()) broadcast to every row."""
    b, hq, d = q.shape
    p = torch.softmax(_decode_logits(q, k_cache, kpos, pos), dim=-1)
    o = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def flash_attention_append_ref(q, k, v, kpos, *, pos0: int,
                               window: Optional[int] = None) -> torch.Tensor:
    """q (B,C,Hq,D) at absolute positions pos0 + i; k,v (B,Sk,Hkv,D) the
    key stream (cache prefix + chunk); kpos (B,Sk) [or (Sk,)] absolute
    position per key row (-1 = invalid) -> (B,C,Hq,D).  Causal (and
    windowed) on absolute positions."""
    b, c, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kpos = kpos.expand(b, sk)
    qpos = pos0 + torch.arange(c, device=q.device)
    qg = q.reshape(b, c, hkv, g, d).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) * d ** -0.5
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    if window is not None:
        mask &= kpos[:, None, :] > qpos[None, :, None] - window
    logits = torch.where(mask[:, :, None, None, :], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    return o.reshape(b, c, hq, d).to(q.dtype)


def decode_attention_partials_ref(q, k_cache, v_cache, kpos, pos,
                                  k_scale=None, v_scale=None):
    """Flash-decoding partials over a (local) cache slice: the arguments of
    ``decode_attention_ref`` (int8 caches with their (B,L,Hkv,1) f32
    scales) -> the unnormalised online-softmax state (acc (B,Hkv,G,D),
    m (B,Hkv,G), l (B,Hkv,G)), all f32.  A masked key scores the finite
    NEG, so a fully masked slice gives m = NEG, l = its number of keys and
    acc = the sum of its v rows (the TPU kernel's semantics)."""
    if k_scale is not None:
        k_cache = dequant_ref(k_cache, k_scale)
        v_cache = dequant_ref(v_cache, v_scale)
    logits = _decode_logits(q, k_cache, kpos, pos)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return acc, m, p.sum(dim=-1)


def combine_partials(parts):
    """Combine (acc, m, l) partials of disjoint cache slices into the
    attention output (B, Hq, D) f32: o = sum(acc * e^(m - max m)) /
    sum(l * e^(m - max m)), the cross-shard combine of the context-parallel
    decode (``repro/kernels/dispatch.py::_decode_cp_call``) taken here over
    a list.  A slice that others outweigh vanishes (its correction
    underflows to 0); a row masked everywhere keeps the mean of v."""
    m_max = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    corr = [torch.exp(m - m_max) for _, m, _ in parts]
    l_tot = sum(l * c for (_, _, l), c in zip(parts, corr))
    acc_tot = sum(acc * c[..., None] for (acc, _, _), c in zip(parts, corr))
    o = acc_tot / torch.clamp(l_tot, min=L_FLOOR)[..., None]
    b, hkv, g, d = o.shape
    return o.reshape(b, hkv * g, d)


# ---------------------------------------------------------------------------
# int8 KV: each quant plain version is the standalone dequantisation
# (``kv_quant.dequantize``) composed with the float plain version, so a
# kernel that dequantises inside its body must match dequantise-then-attend
# ---------------------------------------------------------------------------

def dequant_ref(q8, scale, dtype=torch.float32) -> torch.Tensor:
    return kv_quant.dequantize(q8, scale, dtype)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale, kpos,
                               pos) -> torch.Tensor:
    """``decode_attention_ref`` over int8 caches with (B,L,Hkv,1) scales."""
    return decode_attention_ref(q, dequant_ref(k_cache, k_scale),
                                dequant_ref(v_cache, v_scale), kpos, pos)


def flash_attention_append_quant_ref(q, k, v, k_scale, v_scale, kpos, *,
                                     pos0: int,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
    """``flash_attention_append_ref`` over an int8 key stream with
    (B,Sk,Hkv,1) scales."""
    return flash_attention_append_ref(q, dequant_ref(k, k_scale),
                                      dequant_ref(v, v_scale), kpos,
                                      pos0=pos0, window=window)
