"""A plain float32 forward of GraniteMoeHybrid (Granite-4.0-H), in
``torch`` operations alone: no kernel, cache or batching of its own, and
nothing of ``repro`` or ``repro_torch``.  It reads the port's parameter
names (``layers.3.mamba.in_proj.w``, ...) and takes the model as a dict of
the port's ``ModelConfig`` fields.

Each layer (pre-norm; RMSNorm x * rsqrt(mean(x^2) + rms_norm_eps) * scale):

  * the mixer: a Mamba-2 layer where ``block_cycle`` says ``mamba2``,
    causal GQA attention otherwise; x += residual_multiplier * mixer(n1(x));
  * x += residual_multiplier * (MoE(n2(x)) + shared(n2(x))).

The Mamba-2 mixer, written as its sequential recurrence: in_proj gives z,
xBC and dt; a depthwise causal conv of width W (with bias) and SiLU over
xBC, split into x (H heads of P), B and C (G groups of N, head h reading
group h // (H / G)); dt = softplus(dt + dt_bias), a = exp(-dt exp(A_log));
h_t = a_t h_{t-1} + dt_t B_t (x) x_t from h_0 = 0, y_t = C_t . h_t + D x_t;
then RMSNorm(y * SiLU(z)) and out_proj.  Attention: no positional encoding
(NoPE), scores times ``attention_multiplier``.  The MoE: the router's
logits in f32 over all ``n_experts``; each token's top_k experts by a
stable descending sort of the logits, gated by the softmax over those k
logits; only experts [first, first + held) are computed (the held share,
the program's cut); each a SiLU-gated MLP; the shared expert a SiLU-gated
MLP on every token.  The embedding's rows times ``embedding_multiplier``,
the logits (the tied table's transpose) divided by ``logits_scaling``.

Departures from the published description, each the program's as well:
the value head (one output on the final norm's rows, the A3C critic); the
Switch load-balance loss returned as ``aux`` (E sum_e f_e P_e, f_e the
share of tokens whose first choice is e, P_e the mean softmax
probability); the held share of the experts where ``experts_held`` is set.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kinds(m: dict) -> list:
    cyc = list(m["block_cycle"])
    return (cyc * -(-m["n_layers"] // len(cyc)))[:m["n_layers"]]


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def mamba(f, pre, x, m):
    """The Mamba-2 mixer over x (B, S, d), by its recurrence."""
    b, s, _ = x.shape
    hh, pd, n, g = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], \
        m["ssm_groups"]
    di = hh * pd
    proj = x @ f[pre + "in_proj.w"]
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * g * n], \
        proj[..., 2 * di + 2 * g * n:]
    w, bias = f[pre + "conv_w"], f[pre + "conv_b"]
    width = w.shape[0]
    xp = torch.cat([xbc.new_zeros(b, width - 1, xbc.shape[2]), xbc], 1)
    conv = sum(xp[:, i:i + s] * w[i] for i in range(width)) + bias
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(b, s, hh, pd)
    bm = conv[..., di:di + g * n].reshape(b, s, g, n)
    cm = conv[..., di + g * n:].reshape(b, s, g, n)
    grp = torch.arange(hh) // (hh // g)
    bm, cm = bm[:, :, grp], cm[:, :, grp]                 # (B, S, H, N)
    dt = F.softplus(dt + f[pre + "dt_bias"])               # (B, S, H)
    a = torch.exp(-dt * torch.exp(f[pre + "A_log"]))
    h = x.new_zeros(b, hh, n, pd)
    ys = []
    for t in range(s):
        h = a[:, t, :, None, None] * h + \
            (dt[:, t, :, None, None] * bm[:, t, :, :, None]
             * xs[:, t, :, None, :])
        ys.append((cm[:, t, :, :, None] * h).sum(2))       # (B, H, P)
    y = torch.stack(ys, 1) + xs * f[pre + "D"][:, None]
    y = y.reshape(b, s, di) * F.silu(z)
    return rmsnorm(y, f[pre + "norm.scale"], m["rms_norm_eps"]) @ \
        f[pre + "out_proj.w"]


def attention(f, pre, x, m):
    b, s, _ = x.shape
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (x @ f[pre + "wq.w"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = (x @ f[pre + "wk.w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (x @ f[pre + "wv.w"]).reshape(b, s, hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(hq // hkv, dim=1)
    v = v.repeat_interleave(hq // hkv, dim=1)
    sc = (q @ k.transpose(-1, -2)) * m["attention_multiplier"]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    sc = sc.masked_fill(~mask, float("-inf"))
    o = torch.softmax(sc, -1) @ v
    return o.transpose(1, 2).reshape(b, s, hq * hd) @ f[pre + "wo.w"]


def gated(f, pre, x):
    return (F.silu(x @ f[pre + "gate.w"]) * (x @ f[pre + "up.w"])) @ \
        f[pre + "down.w"]


def moe(f, pre, x, m, first: int = 0):
    """(the held experts' gated sum (B, S, d), the load-balance loss)."""
    b, s, d = x.shape
    e, k = m["n_experts"], m["top_k"]
    xf = x.reshape(-1, d)
    logits = xf @ f[pre + "router"]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], -1)
    idx = idx[:, :k]
    y = torch.zeros_like(xf)
    for j in range(f[pre + "w_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == first + j, as_tuple=True)
        if tok.numel():
            rows = xf[tok]
            out = (F.silu(rows @ f[pre + "w_gate"][j]) *
                   (rows @ f[pre + "w_up"][j])) @ f[pre + "w_down"][j]
            y = y.index_add(0, tok, out * gates[tok, slot, None])
    top1 = F.one_hot(idx[:, 0], e).float().mean(0)
    lb = e * torch.sum(top1 * torch.softmax(logits, -1).mean(0))
    return y.reshape(b, s, d), lb


def forward(m: dict, f: dict, tokens: torch.Tensor) -> dict:
    """tokens (B, S) -> {"logits" (B, S, V), "value" (B, S), "aux" ()}, all
    f32; ``f`` the flat parameters, cast up to f32 here."""
    f = {k: v.float() for k, v in f.items()}
    eps, r = m["rms_norm_eps"], m["residual_multiplier"]
    x = f["embed.table"][tokens] * m["embedding_multiplier"]
    aux = x.new_zeros(())
    for i, kind in enumerate(kinds(m)):
        pre = f"layers.{i}."
        h = rmsnorm(x, f[pre + "ln1.scale"], eps)
        if kind == "mamba2":
            h = mamba(f, pre + "mamba.", h, m)
        else:
            h = attention(f, pre + "attn.", h, m)
        x = x + r * h
        h = rmsnorm(x, f[pre + "ln2.scale"], eps)
        y, lb = moe(f, pre + "moe.", h, m)
        x = x + r * (y + gated(f, pre + "shared.", h))
        aux = aux + lb
    x = rmsnorm(x, f["final_norm.scale"], eps)
    return {"logits": (x @ f["embed.table"].T) / m["logits_scaling"],
            "value": (x @ f["value_head.w"])[..., 0], "aux": aux}
