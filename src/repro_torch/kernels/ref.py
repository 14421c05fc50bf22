"""Plain PyTorch versions of the kernels on the serving path.

Counterparts of ``repro/kernels/ref.py``'s oracles, written in PyTorch
with the same arithmetic: f32 math, the finite ``NEG`` mask and grouped
query heads that never repeat the kv heads.  The CPU path of every
kernel wrapper runs these, and ``chip_smoke.py`` holds each CUDA kernel to
them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """y = x * rsqrt(mean(x^2) + eps) * scale in f32, cast to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def decode_attention_ref(q, k_cache, v_cache, kpos, pos) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) absolute position per slot
    (-1 = empty); pos (B,) current position per sequence -> (B,Hq,D).
    Lockstep shapes (kpos (L,), pos ()) broadcast to every row."""
    b, hq, d = q.shape
    length, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    kpos = kpos.expand(b, length)
    pos = torch.as_tensor(pos, device=q.device).expand(b)
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,blhd->bhgl", qg, k_cache.float()) * d ** -0.5
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    p = torch.softmax(logits, dim=-1)
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
