"""Traffic model of the serving path: bytes a decode step moves.

The port's share of ``repro/launch/traffic.py``: the byte count the serve
report prints for the context-parallel decode.
"""
from __future__ import annotations


def decode_cp_combine_bytes(cfg, batch: int, n_seq_shards: int) -> int:
    """Bytes per decoded token of the context-parallel combine: every
    attention layer all-reduces three f32 partials, acc (B, Hq, D), m and l
    (B, Hq), across the ``n_seq_shards`` sequence shards.  Whole-group
    total (each shard contributes its copy); the alternative this replaces
    is gathering the KV cache every layer."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "attn_local"))
    per_layer = batch * cfg.n_heads * (cfg.hd + 2) * 4
    return n_attn * per_layer * n_seq_shards
