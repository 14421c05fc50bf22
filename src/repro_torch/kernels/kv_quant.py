"""KV-cache storage dtypes.

The port's part of ``repro/kernels/kv_quant.py``: the CLI names and the
quantised-dtype test.  Int8 KV caches (quantise on write, dequantise in
the kernels) are a later slice; asking for one raises.
"""
from __future__ import annotations

import torch

KV_DTYPES = ("f32", "bf16", "int8")
INT8_ITEM = ("see ROADMAP.md, queue 1, slice 3: paged KV, int8 KV and "
             "speculative serving")


def resolve_kv_dtype(name) -> torch.dtype:
    """CLI/config name -> torch dtype (passthrough for torch dtypes)."""
    table = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}
    if isinstance(name, str):
        if name not in table:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {name!r}")
        name = table[name]
    if is_quantized(name):
        raise NotImplementedError(f"int8 KV caches are not ported yet "
                                  f"({INT8_ITEM})")
    return name


def is_quantized(dtype) -> bool:
    return dtype == torch.int8
