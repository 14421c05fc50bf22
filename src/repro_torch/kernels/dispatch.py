"""Kernel dispatch: the model layer's single entry to the kernels.

Counterpart of ``repro/kernels/dispatch.py`` for the ops on the serving
path.  Routing is by the tensor's device: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version (the
wrappers make that choice, on the device alone).  There is no alignment
arm: the JAX dispatch's 128-multiple fallbacks exist for the TPU's tiles,
while these kernels mask their own ragged edges, so a CUDA call never
falls back.  What stays from the JAX layer is the per-slot normalisation
of the decode call (scalar ``pos`` and 1-D ``kpos`` broadcast, ``pos=None``
meaning ``max(kpos)``) and the GQA check.

Each wrapper counts its launches; ``launch_counts`` / ``reset_launch_counts``
read and clear them, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import (decode_attention_cuda, flash_append_cuda,
                                 kv_quant, rmsnorm_cuda)

_WRAPPERS = {"rmsnorm": rmsnorm_cuda,
             "flash_append": flash_append_cuda,
             "decode_attention": decode_attention_cuda}


def launch_counts() -> Dict[str, int]:
    return {op: mod.launches for op, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def _no_quant(k_scale, op: str) -> None:
    if k_scale is not None:
        raise NotImplementedError(
            f"{op}: int8 KV caches are not ported yet "
            f"({kv_quant.INT8_ITEM})")


def _check_gqa(hq: int, hkv: int) -> None:
    if hq % hkv != 0:
        raise ValueError(f"GQA needs q heads to be a multiple of kv heads, "
                         f"got {hq}/{hkv}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm over the last dim of an activation of any rank."""
    shape = x.shape
    y = rmsnorm_cuda.rmsnorm_fwd(x.reshape(-1, shape[-1]), scale, eps=eps)
    return y.reshape(shape)


def flash_attention_append(q, k, v, kpos, *, pos0: int,
                           window: Optional[int] = None,
                           kpos_linear: bool = False,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Append-mode attention for chunked prefill: q (B,C,Hq,D) at absolute
    positions pos0 + i; k,v (B,Sk,Hkv,D) the key stream (cache prefix +
    chunk); kpos (B,Sk) [or (Sk,), broadcast] absolute position per key row
    (-1 = invalid) -> (B,C,Hq,D).  ``kpos_linear`` asserts key row index ==
    absolute position wherever valid (linear caches) and enables the
    dead-tile skip; ring layouts leave it False."""
    _no_quant(k_scale, "flash_attention_append")
    b, sk = q.shape[0], k.shape[1]
    _check_gqa(q.shape[2], k.shape[2])
    kpos = kpos.to(torch.int32).expand(b, sk).contiguous()
    return flash_append_cuda.flash_attention_append(
        q, k, v, kpos, pos0=pos0, window=window, kpos_linear=kpos_linear)


def decode_attention(q, k_cache, v_cache, kpos, pos=None, *,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L); pos (B,) -> (B,Hq,D).

    Positions are per batch slot; lockstep callers may pass kpos (L,) and
    a scalar pos, broadcast here to the per-slot layout.  ``pos=None``
    means each row's max(kpos)."""
    _no_quant(k_scale, "decode_attention")
    b, length = q.shape[0], k_cache.shape[1]
    _check_gqa(q.shape[1], k_cache.shape[2])
    if pos is None:
        pos = kpos.amax(dim=-1)
    pos = torch.as_tensor(pos, device=q.device)
    kpos = kpos.to(torch.int32).expand(b, length).contiguous()
    pos = pos.to(torch.int32).expand(b).contiguous()
    return decode_attention_cuda.decode_attention_fwd(q, k_cache, v_cache,
                                                      kpos, pos)
