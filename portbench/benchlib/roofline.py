"""The yardstick: the H100's peaks, each kernel's least operations and
bytes, and the model FLOPs of a step, frozen here so that a change to the
program cannot move them.

Peaks: NVIDIA H100 SXM, dense, at its 700 W limit: 989e12 bf16 FLOP/s on
the tensor cores, 3.35e12 B/s of HBM.  A kernel's bound is the larger of
its operations over the FLOP peak and its bytes over the byte peak,
counting each input byte read once and each output byte written once,
and only the work its inputs need (the formulas of ``chip_smoke.py``'s
``_flash_bound``, ``_append_record`` and ``_decode_bytes``, the cache
bytes of ``launch/traffic.py``).
"""
from __future__ import annotations

from benchlib import layout

PEAK_BF16 = 989e12
HBM_BYTES = 3.35e12
BF16 = 2


def _bound(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / HBM_BYTES)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flash_fwd_s(b: int, s: int, hq: int, hkv: int, d: int) -> float:
    """Kernel 3 (bf16, causal): four products of D a live (query, key)
    pair; q, o and k, v in and out once, the f32 lse out."""
    live = causal_pairs(s) * b * hq
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * BF16 + \
        b * hq * s * 4
    return _bound(4 * d * live, nbytes)


def flash_bwd_s(b: int, s: int, hq: int, hkv: int, d: int) -> float:
    """Kernel 5 (bf16, causal): s, dp, dq, dk, dv, ten products of D a live
    pair; q, o, do, dq and k, v, dk, dv once, lse once."""
    live = causal_pairs(s) * b * hq
    nbytes = (4 * b * s * hq * d + 4 * b * s * hkv * d) * BF16 + \
        b * hq * s * 4
    return _bound(10 * d * live, nbytes)


def append_s(rows, hq: int, hkv: int, d: int) -> float:
    """Kernel 4 over the real rows of one prefill chunk: ``rows`` is a list
    of (pos0, n): n query positions from pos0, each against the keys
    0 .. its own position.  q, o in and out; the keys and values up to the
    chunk's end read once; kpos once."""
    pairs = sum(n * pos0 + causal_pairs(n) for pos0, n in rows)
    keys = sum(pos0 + n for pos0, n in rows)
    q = sum(n for _, n in rows)
    nbytes = (2 * q * hq * d + 2 * keys * hkv * d) * BF16 + keys * 4
    return _bound(4 * hq * d * pairs, nbytes)


def decode_s(keys, hq: int, hkv: int, d: int) -> float:
    """Kernel 6 over the live slots of one decode step: ``keys`` the valid
    cache rows of each (position + 1).  K and V of those rows, q in, the
    output, kpos and pos."""
    n = sum(keys)
    b = len(keys)
    nbytes = 2 * n * hkv * d * BF16 + 2 * b * hq * d * BF16 + n * 4 + b * 4
    return _bound(4 * hq * d * n, nbytes)


def train_step_flops(model: dict, rows: int, seq: int,
                     n_params: int) -> float:
    """Model FLOPs of a training step: 6 N a token, N the parameters of the
    products a token passes (``layout.product_params``), and 6 S^2 Hq D a
    layer and sequence for causal attention; remat's recompute is not
    counted."""
    hq, d = model["n_heads"], layout.head_dim(model)
    attn = 6 * seq * seq * hq * d * model["n_layers"] * rows
    return 6.0 * n_params * rows * seq + attn


def kv_row_bytes(model: dict) -> int:
    """Bytes of one token's K and V over every layer, bf16."""
    return 2 * model["n_kv_heads"] * layout.head_dim(model) * BF16 * \
        model["n_layers"]


def decode_least_s(model: dict, keys, layer_params: int, head_params: int,
                   weight_bytes: int) -> float:
    """Least time of a decode step over its live slots (``keys``: each
    one's valid cache rows): every weight read once, each slot's cache
    rows read and its new row written; the layers' and head's products
    and attention over the valid rows."""
    n = len(keys)
    hq, d = model["n_heads"], layout.head_dim(model)
    ops = 2 * (layer_params + head_params) * n + \
        4 * hq * d * sum(keys) * model["n_layers"]
    nbytes = weight_bytes + kv_row_bytes(model) * (sum(keys) + n)
    return _bound(ops, nbytes)


def prefill_least_s(model: dict, rows, last_rows: int, layer_params: int,
                    head_params: int, weight_bytes: int) -> float:
    """Least time of one prefill chunk over its real rows (``rows``: (pos0,
    n) of each), the head only for the ``last_rows`` rows whose last
    prompt token it holds: every weight read once, the prefix's cache rows
    read and the chunk's written."""
    hq, d = model["n_heads"], layout.head_dim(model)
    toks = sum(n for _, n in rows)
    pairs = sum(n * pos0 + causal_pairs(n) for pos0, n in rows)
    ops = 2 * layer_params * toks + 2 * head_params * last_rows + \
        4 * hq * d * pairs * model["n_layers"]
    prefix = sum(pos0 for pos0, _ in rows)
    nbytes = weight_bytes + kv_row_bytes(model) * (prefix + toks)
    return _bound(ops, nbytes)
