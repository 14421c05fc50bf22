"""Symmetric int8 KV-cache quantisation: the quant/dequant pair.

Counterpart of ``repro/kernels/kv_quant.py``.  One scheme everywhere
(model-layer writes, the kernels' dequantisation, the plain versions):

  * per-(cache row, kv head) symmetric absmax: each written row
    ``(..., Hkv, D)`` carries an f32 scale ``(..., Hkv, 1)``, rank-matched
    to its payload so every row copy of a K/V leaf applies to its scale
    leaf verbatim;
  * zero-initialised scales dequantise to exact zeros (kpos masks unwritten
    rows anyway);
  * deterministic round half to even (``torch.round``, as ``jnp.round``)
    and a true division by ``max(scale, EPS)``, so the cache bytes are the
    JAX package's bit for bit.

The CUDA kernels dequantise the same way after their 16-byte loads
(int8 -> f32, times the row's scale), so the device-memory stream stays
int8.
"""
from __future__ import annotations

import torch

QMAX = 127.0
# absmax floor: rows of exact zeros quantise with scale 0 (dequant gives
# zeros back); any nonzero row divides by at least this
EPS = 1e-12

KV_DTYPES = ("f32", "bf16", "int8")
_TABLE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def resolve_kv_dtype(name) -> torch.dtype:
    """CLI/config name -> torch dtype (passthrough for the three torch
    dtypes; anything else raises)."""
    if isinstance(name, str):
        if name not in _TABLE:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {name!r}")
        return _TABLE[name]
    if name not in _TABLE.values():
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES} or their "
                         f"torch dtypes, got {name!r}")
    return name


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> the short CLI/report name ("f32", "bf16", "int8")."""
    return {v: k for k, v in _TABLE.items()}[dtype]


def is_quantized(dtype) -> bool:
    return dtype == torch.int8


def quantize(x: torch.Tensor):
    """Symmetric per-(row, head) absmax quantisation over the last dim:
    x (..., D) float -> (q (..., D) int8, scale (..., 1) f32) with
    q * scale ~= x."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / QMAX
    q = torch.round(xf / torch.clamp(scale, min=EPS))
    return q.clamp(-QMAX, QMAX).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (..., D) int8, scale (..., 1) f32 -> (..., D) ``dtype``."""
    return (q.float() * scale).to(dtype)
