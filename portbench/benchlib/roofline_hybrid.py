"""The yardstick of Granite-4.0-H's cells, frozen here so that a change to
the program cannot move it: the least time of a prefill chunk or a decode
step (``mfu.hybrid``) and the bound of one Mamba-2 mixer call's scan
(``ssd_roofline.hybrid``).  Peaks and ``_bound`` are ``roofline``'s: the
larger of operations over 989e12 FLOP/s and bytes over 3.35e12 B/s.

The scan's least work is its recurrence's: a position of a head decays
its state, adds dt B (x) x and reads C . h, 5 N P operations, whatever
form the program computes (the chunked form does more); its bytes are the
f32 state written once a row (and read too at a decode step, whose
positions equal its rows) and each real position's activations read or
written once (x and B, C in bf16, dt and y in f32).

A step's least time counts the useful work only: the real prompt rows of
a chunk, every weight read once (the experts held here: those the tokens
hit, expected under uniform routing, E_held (1 - (1 - k / E)^T) for T
tokens), the products of every layer a token passes (its share k E_held /
E of held experts), the scan's recurrence, attention over the valid
rows, the head only for the rows whose next token is drawn, the f32
states and the KV rows read and written once."""
from __future__ import annotations

from benchlib import layout as dense
from benchlib import layout_hybrid as lay
from benchlib import roofline

F32, BF16 = 4, roofline.BF16


def _sizes(model: dict) -> dict:
    d = model["d_model"]
    h, p, n = model["ssm_heads"], model["ssm_head_dim"], model["ssm_state"]
    gn = model["ssm_groups"] * n
    di = h * p
    hd = dense.head_dim(model)
    ks = lay.kinds(model)
    return dict(
        d=d, h=h, p=p, n=n, gn=gn,
        mamba=d * (2 * di + 2 * gn + h) + di * d,
        conv=(di + 2 * gn) * (model["ssm_conv_width"] - 1),
        attn=d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"]),
        router=d * model["n_experts"],
        shared=3 * d * model["d_ff_shared"],
        expert=3 * d * model["d_ff_expert"],
        head=d * (model["vocab_size"] + 1),
        n_mamba=ks.count("mamba2"), n_attn=len(ks) - ks.count("mamba2"),
        layers=len(ks), hd=hd)


def ssd_s(model: dict, rows: int, positions: int, masked: int) -> float:
    """The bound of one ``model.ssm`` call over ``rows`` rows and
    ``positions`` positions, ``masked`` of them padding (its counts)."""
    z = _sizes(model)
    real = positions - masked
    ops = 5 * z["h"] * z["n"] * z["p"] * real
    state = z["h"] * z["n"] * z["p"] * F32 * rows * \
        (2 if positions == rows else 1)
    act = real * (z["h"] * z["p"] * (BF16 + F32) + 2 * z["gn"] * BF16 +
                  z["h"] * F32)
    return roofline._bound(ops, state + act)


def _expert_share(model: dict, tokens: int):
    """(held assignments a layer, held experts hit a layer) for ``tokens``
    tokens under uniform routing."""
    e, k, eh = model["n_experts"], model["top_k"], lay.held(model)
    return tokens * k * eh / e, eh * (1.0 - (1.0 - k / e) ** tokens)


def _state_bytes(z: dict) -> int:
    """One row's f32 Mamba-2 states over the layers: h and the conv's."""
    return (z["h"] * z["n"] * z["p"] + z["conv"]) * F32 * z["n_mamba"]


def _kv_row(model: dict, z: dict) -> int:
    return 2 * model["n_kv_heads"] * z["hd"] * BF16 * z["n_attn"]


def _layer_ops_bytes(model: dict, z: dict, tokens: int):
    """(operations, weight bytes) of ``tokens`` tokens through the layers'
    products, the experts as ``_expert_share``."""
    assign, hit = _expert_share(model, tokens)
    per = z["router"] + z["shared"]
    ops = 2 * tokens * (z["n_mamba"] * z["mamba"] + z["n_attn"] * z["attn"]
                        + z["layers"] * per) + \
        2 * z["expert"] * assign * z["layers"] + \
        5 * z["h"] * z["n"] * z["p"] * tokens * z["n_mamba"]
    wbytes = BF16 * (z["n_mamba"] * z["mamba"] + z["n_attn"] * z["attn"] +
                     z["layers"] * (per + z["expert"] * hit))
    return ops, wbytes


def decode_least_s(model: dict, keys) -> float:
    """A decode step over its live slots (``keys``: each one's valid cache
    rows)."""
    z = _sizes(model)
    n = len(keys)
    ops, wbytes = _layer_ops_bytes(model, z, n)
    ops += 2 * z["head"] * n + \
        4 * model["n_heads"] * z["hd"] * sum(keys) * z["n_attn"]
    nbytes = wbytes + BF16 * z["head"] + 2 * _state_bytes(z) * n + \
        _kv_row(model, z) * (sum(keys) + n)
    return roofline._bound(ops, nbytes)


def prefill_least_s(model: dict, rows, last_rows: int) -> float:
    """One prefill chunk over its real rows (``rows``: (pos0, n) of each),
    the head only for the ``last_rows`` rows whose last prompt token it
    holds; a row's states written, and read where it starts past 0."""
    z = _sizes(model)
    toks = sum(n for _, n in rows)
    pairs = sum(n * p0 + roofline.causal_pairs(n) for p0, n in rows)
    ops, wbytes = _layer_ops_bytes(model, z, toks)
    ops += 2 * z["head"] * last_rows + \
        4 * model["n_heads"] * z["hd"] * pairs * z["n_attn"]
    states = sum(2 if p0 else 1 for p0, _ in rows) * _state_bytes(z)
    prefix = sum(p0 for p0, _ in rows)
    nbytes = wbytes + (BF16 * z["head"] if last_rows else 0) + states + \
        _kv_row(model, z) * (prefix + toks)
    return roofline._bound(ops, nbytes)
