"""The plain reference: a decoder of attention blocks with a gated (SwiGLU)
MLP or a Mixture-of-Experts layer, in float32 PyTorch with no kernel,
cache or batching of its own.  It imports nothing of the program.

Each block (pre-norm, as Llama and Granite): x += Wo attn(RoPE(Wq n1(x)),
RoPE(Wk n1(x)), Wv n1(x)), causal, grouped-query (q head h reads kv head
h // (Hq / Hkv)), scores scaled by 1 / sqrt(head_dim); then x += FFN(n2(x))
with n the RMSNorm x * rsqrt(mean(x^2) + 1e-6) * scale.  RoPE rotates the
two halves of each head (theta from the configuration).  The heads: the
final norm, the LM head (the embedding's transpose where tied) and a
value head of one output (the A3C critic).

The MoE layer (Switch-style capacity, as the program's): the router's
softmax in f32, each token's top_k experts by a stable descending sort,
their gates renormalised over the k; an expert holds
int(max(k, capacity_factor * T * k / E)) slots (at most T, the tokens of
the call); a slot goes to the assignments in token-major order and an
assignment past its expert's capacity is dropped; the load-balance loss
E * sum_e f_e P_e, f_e the share of tokens whose first choice is e.

Departures from the published models, each the program's as well: no
embedding, attention, residual or logit multipliers (Granite-3.0 has
them), a capacity that can drop assignments (Granite-3.0's experts are
dropless), an RMSNorm epsilon of 1e-6 (Yi-6B states 1e-5), and the
value head.

``lowp`` (``reference/lowp.py``) rounds the operands of every product
to a lower precision, for the control; None computes in float32.  Call
``exact()`` first on the card: TF32 off.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

EPS = 1e-6


def exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q(lowp, t):
    return t if lowp is None else lowp(t)


def mm(lowp, a, b):
    return _q(lowp, a) @ _q(lowp, b)


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale


def rope_tables(positions, hd: int, theta: float):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=positions.device) / hd)
    ang = positions.float()[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """x (B, S, H, D); cos, sin (S, D/2)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(f, pre, x, model, lowp, cos, sin, heads_at_once: int = 8):
    b, s, _ = x.shape
    hq, hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // hq
    q = mm(lowp, x, f[pre + "wq.w"]).reshape(b, s, hq, hd)
    k = mm(lowp, x, f[pre + "wk.w"]).reshape(b, s, hkv, hd)
    v = mm(lowp, x, f[pre + "wv.w"]).reshape(b, s, hkv, hd)
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)     # (B, Hq, S, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for h0 in range(0, hq, heads_at_once):
        sl = slice(h0, h0 + heads_at_once)
        sc = mm(lowp, q[:, sl], k[:, sl].transpose(-1, -2)) / math.sqrt(hd)
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(mm(lowp, torch.softmax(sc, dim=-1), v[:, sl]))
    o = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, s, hq * hd)
    return mm(lowp, o, f[pre + "wo.w"])


def mlp(f, pre, x, lowp):
    gate = mm(lowp, x, f[pre + "gate.w"])
    up = mm(lowp, x, f[pre + "up.w"])
    return mm(lowp, torch.nn.functional.silu(gate) * up, f[pre + "down.w"])


def moe(f, pre, x, model, lowp):
    """(y, load-balance loss) of the MoE layer over every token of x."""
    b, s, d = x.shape
    e, k = model["n_experts"], model["top_k"]
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(xf @ f[pre + "router"], dim=-1)        # (T, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    top1 = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(0)
    lb = e * torch.sum(top1 * probs.mean(0))
    cap = min(int(max(k, model.get("capacity_factor", 1.25) * t * k / e)), t)
    flat = idx.reshape(-1)                                        # (T*k,)
    onehot = torch.nn.functional.one_hot(flat, e)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = pos < cap
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    g = gates.reshape(-1)
    y = torch.zeros_like(xf)
    for ex in range(e):
        sel = torch.nonzero((flat == ex) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        rows = xf[tok[sel]]
        h = torch.nn.functional.silu(mm(lowp, rows, f[pre + "w_gate"][ex])) \
            * mm(lowp, rows, f[pre + "w_up"][ex])
        out = mm(lowp, h, f[pre + "w_down"][ex]) * g[sel, None]
        y = y.index_add(0, tok[sel], out)
    return y.reshape(b, s, d), lb


def block(f, i, x, model, lowp, cos, sin):
    pre = f"layers.{i}."
    x = x + attention(f, pre + "attn.", rmsnorm(x, f[pre + "ln1.scale"]),
                      model, lowp, cos, sin)
    h = rmsnorm(x, f[pre + "ln2.scale"])
    if model.get("n_experts"):
        y, lb = moe(f, pre + "moe.", h, model, lowp)
        return x + y, lb
    return x + mlp(f, pre + "mlp.", h, lowp), torch.zeros((), device=x.device)


def forward(model: dict, f: dict, tokens: torch.Tensor, *, lowp=None,
            remat: bool = False) -> dict:
    """tokens (B, S) -> {"logits" (B, S, V), "value" (B, S), "aux" ()}, all
    f32; ``f`` the flat parameters (float32, or lower and cast up here).
    ``remat``: each block recomputed in the backward, so that the
    reference's activations fit beside a full-size cell."""
    f = {k: (v if v.dtype == torch.float32 else v.float())
         for k, v in f.items()}
    s = tokens.shape[1]
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    cos, sin = rope_tables(torch.arange(s, device=tokens.device), hd,
                           model["rope_theta"])
    x = f["embed.table"][tokens]
    aux = torch.zeros((), device=x.device)
    for i in range(model["n_layers"]):
        if remat:
            x, lb = checkpoint(block, f, i, x, model, lowp, cos, sin,
                               use_reentrant=False)
        else:
            x, lb = block(f, i, x, model, lowp, cos, sin)
        aux = aux + lb
    x = rmsnorm(x, f["final_norm.scale"])
    head = f["embed.table"].T if model.get("tie_embeddings") \
        else f["lm_head.w"]
    return {"logits": mm(lowp, x, head),
            "value": (x @ f["value_head.w"])[..., 0], "aux": aux}
