"""The parameter layout of a decoder of attention blocks with a gated MLP
or a Mixture-of-Experts layer: flat path -> (shape, spread), in the
port's leaf names, which are its input format (the reference reads the
same names).  Matrices are drawn with the spread given here; vectors
(norm scales) are ones.

``model`` is the configuration file's ``model`` entry: n_layers,
d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab_size, n_experts,
d_ff_expert, tie_embeddings, value_head.
"""
from __future__ import annotations

import math


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def layout(model: dict) -> dict:
    """{path: (shape, std)}, std None for a vector of ones."""
    d, v = model["d_model"], model["vocab_size"]
    hd = head_dim(model)
    hq, hkv = model["n_heads"], model["n_kv_heads"]

    def lin(d_in, d_out):
        return ((d_in, d_out), 1.0 / math.sqrt(d_in))
    out = {"embed.table": ((v, d), 0.02), "final_norm.scale": ((d,), None)}
    if not model.get("tie_embeddings", False):
        out["lm_head.w"] = lin(d, v)
    if model.get("value_head", True):
        out["value_head.w"] = lin(d, 1)
    for i in range(model["n_layers"]):
        p = f"layers.{i}."
        out[p + "ln1.scale"] = ((d,), None)
        out[p + "attn.wq.w"] = lin(d, hq * hd)
        out[p + "attn.wk.w"] = lin(d, hkv * hd)
        out[p + "attn.wv.w"] = lin(d, hkv * hd)
        out[p + "attn.wo.w"] = lin(hq * hd, d)
        out[p + "ln2.scale"] = ((d,), None)
        if model.get("n_experts"):
            e, f = model["n_experts"], model["d_ff_expert"]
            out[p + "moe.router"] = ((d, e), 0.02)
            out[p + "moe.w_gate"] = ((e, d, f), 1.0 / math.sqrt(d))
            out[p + "moe.w_up"] = ((e, d, f), 1.0 / math.sqrt(d))
            out[p + "moe.w_down"] = ((e, f, d), 1.0 / math.sqrt(f))
        else:
            f = model["d_ff"]
            out[p + "mlp.gate.w"] = lin(d, f)
            out[p + "mlp.up.w"] = lin(d, f)
            out[p + "mlp.down.w"] = lin(f, d)
    return out


def shapes(model: dict) -> dict:
    return {k: s for k, (s, _) in layout(model).items()}


def unflatten(flat: dict) -> dict:
    """Flat "layers.3.x" paths -> nested dicts, digit keys as lists (the
    port's tree)."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(x) for k, x in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, x in items:
        key = f"{prefix}{k}"
        if isinstance(x, (dict, list)):
            out.update(flatten(x, key + "."))
        else:
            out[key] = x
    return out


def product_params(model: dict) -> int:
    """Parameters of the products one token passes through: every layer's
    projections and MLP (with experts: the router and top_k experts) and
    the LM and value heads; not the embedding lookup nor the norm
    scales."""
    d, v = model["d_model"], model["vocab_size"]
    hd = head_dim(model)
    attn = d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"])
    if model.get("n_experts"):
        ffn = d * model["n_experts"] + \
            model["top_k"] * 3 * d * model["d_ff_expert"]
    else:
        ffn = 3 * d * model["d_ff"]
    head = d * v + (d if model.get("value_head", True) else 0)
    return model["n_layers"] * (attn + ffn) + head
