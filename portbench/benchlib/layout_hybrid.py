"""The parameter layout of Granite-4.0-H (``granitemoehybrid``): flat path
-> (shape, spread) in the port's leaf names, which are its input format
(the reference reads the same names), a layer's leaves contiguous in the
weight stream so that the reference can draw one layer at a time.

Each layer: ``ln1``, the mixer (``mamba``: in_proj, the depthwise conv,
A_log, D, dt_bias, the gated norm, out_proj; or ``attn``: wq, wk, wv, wo),
``ln2``, the experts held here (``moe``: the router over all
``n_experts``, the stacked weights of the first ``experts_held``) and the
shared expert (``shared``).  Spreads are the port's init's: the table
0.02, the router 0.02, the experts' 1/sqrt(d_in), the conv 0.2, every
other matrix 1/sqrt(d_in).  The vectors the stream does not draw (std
None, ones) are set by ``fill_vectors`` as the port's init sets them,
without a draw: A_log = log(linspace(1, 16, H)), dt_bias the inverse
softplus of dt spaced geometrically over [1e-3, 1e-1], the conv bias 0;
D and the norm scales stay one.

``model`` is the configuration file's ``model`` entry (the port's
``ModelConfig`` fields).
"""
from __future__ import annotations

import math

import torch

from benchlib import layout as dense


def kinds(model: dict) -> list:
    cyc = list(model["block_cycle"])
    return (cyc * -(-model["n_layers"] // len(cyc)))[:model["n_layers"]]


def held(model: dict) -> int:
    return model.get("experts_held") or model["n_experts"]


def _lin(d_in: int, d_out: int):
    return ((d_in, d_out), 1.0 / math.sqrt(d_in))


def layer(model: dict, i: int, kind: str) -> dict:
    """One layer's {path: (shape, std)}."""
    d = model["d_model"]
    p = f"layers.{i}."
    out = {p + "ln1.scale": ((d,), None)}
    if kind == "mamba2":
        h, pd = model["ssm_heads"], model["ssm_head_dim"]
        gn = model["ssm_groups"] * model["ssm_state"]
        di = h * pd
        conv = di + 2 * gn
        m = p + "mamba."
        out[m + "in_proj.w"] = _lin(d, 2 * di + 2 * gn + h)
        out[m + "conv_w"] = ((model["ssm_conv_width"], conv), 0.2)
        out[m + "conv_b"] = ((conv,), None)
        for name in ("A_log", "D", "dt_bias"):
            out[m + name] = ((h,), None)
        out[m + "norm.scale"] = ((di,), None)
        out[m + "out_proj.w"] = _lin(di, d)
    else:
        hq, hkv = model["n_heads"], model["n_kv_heads"]
        hd = dense.head_dim(model)
        a = p + "attn."
        out[a + "wq.w"] = _lin(d, hq * hd)
        out[a + "wk.w"] = _lin(d, hkv * hd)
        out[a + "wv.w"] = _lin(d, hkv * hd)
        out[a + "wo.w"] = _lin(hq * hd, d)
    out[p + "ln2.scale"] = ((d,), None)
    e, f = held(model), model["d_ff_expert"]
    out[p + "moe.router"] = ((d, model["n_experts"]), 0.02)
    out[p + "moe.w_gate"] = ((e, d, f), 1.0 / math.sqrt(d))
    out[p + "moe.w_up"] = ((e, d, f), 1.0 / math.sqrt(d))
    out[p + "moe.w_down"] = ((e, f, d), 1.0 / math.sqrt(f))
    fs = model["d_ff_shared"]
    out[p + "shared.gate.w"] = _lin(d, fs)
    out[p + "shared.up.w"] = _lin(d, fs)
    out[p + "shared.down.w"] = _lin(fs, d)
    return out


def layout(model: dict) -> dict:
    """{path: (shape, std)}: the table, the final norm and the value head,
    then the layers in order."""
    d = model["d_model"]
    out = {"embed.table": ((model["vocab_size"], d), 0.02),
           "final_norm.scale": ((d,), None),
           "value_head.w": _lin(d, 1)}
    for i, kind in enumerate(kinds(model)):
        out.update(layer(model, i, kind))
    return out


def fill_vectors(flat: dict, model: dict) -> None:
    """Set the mamba layers' A_log, dt_bias and conv bias in place (the
    module docstring's values; everything else as drawn)."""
    h = model["ssm_heads"]
    for path, t in flat.items():
        name = path.rsplit(".", 1)[-1]
        if name == "A_log":
            t.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
        elif name == "dt_bias":
            dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h))
            t.copy_(torch.log(torch.expm1(dt)))
        elif name == "conv_b":
            t.zero_()
