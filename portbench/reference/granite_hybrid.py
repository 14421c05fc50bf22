"""The plain reference of Granite-4.0-H (``granitemoehybrid``): float32
PyTorch with no kernel, cache or batching of its own, importing nothing
of the program, streamed a layer at a time.

The equations are those of ``tests/torch_ref/granite_hybrid.py`` (its
copy for the benchmark): pre-norm layers (RMSNorm with ``rms_norm_eps``);
x += residual_multiplier * mixer(n1(x)), the mixer Mamba-2 or causal GQA
attention with no positional encoding and scores times
``attention_multiplier``; x += residual_multiplier * (MoE(n2(x)) +
shared(n2(x))), the MoE's router in f32 over all ``n_experts``, each
token's top_k by a stable descending sort of the logits, gated by the
softmax over those k logits, only the held experts computed; the
embedding's rows times ``embedding_multiplier``, the logits (the tied
table's transpose) over ``logits_scaling``; the value head on the final
norm's rows.

The Mamba-2 mixer is computed in its masked quadratic (dual) form, not by
a chunked scan: y_t = sum_{s <= t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s
+ D x_t, cum the running sum of dt a (a = -exp(A_log)), taken in float64
so that the differences of long sums keep float32's precision, a few
heads at a time.

Departures from the published model, each the program's as well: the
value head; the held share of the experts (``experts_held``: what the
absent card's experts add is left out); the mamba vectors set as
``benchlib/layout_hybrid.py`` says.

``gaps`` judges served tokens as ``reference/serve.py`` does, its forward
run once over all the judged sequences, layer by layer: each layer's
weights drawn from the seed (``benchlib/weights.py``'s chunk stream, the
chunks overlapping the layer drawn again, at their own sizes), applied to
every sequence, and freed; 18.6 B parameters in float32 do not fit at
once.  ``lowp`` rounds the operands of every product (the control).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchlib import layout_hybrid as lay
from benchlib import weights
from reference import threefry
from reference.model import exact, mm

HEADS_AT_ONCE = 8


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def mamba(f, pre, x, m, lowp):
    """x (S, d) of one sequence -> the mixer's output (S, d)."""
    s = x.shape[0]
    hh, pd, n, g = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], \
        m["ssm_groups"]
    di, gn = hh * pd, g * n
    proj = mm(lowp, x, f[pre + "in_proj.w"])
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * gn], \
        proj[:, 2 * di + 2 * gn:]
    w = f[pre + "conv_w"]
    width = w.shape[0]
    xp = torch.cat([xbc.new_zeros(width - 1, xbc.shape[1]), xbc])
    conv = F.silu(sum(xp[i:i + s] * w[i] for i in range(width))
                  + f[pre + "conv_b"])
    xs = conv[:, :di].reshape(s, hh, pd)
    bm = conv[:, di:di + gn].reshape(s, g, n)
    cm = conv[:, di + gn:].reshape(s, g, n)
    dt = F.softplus(dt + f[pre + "dt_bias"])                    # (S, H)
    cum = torch.cumsum((dt * -torch.exp(f[pre + "A_log"])).double(), 0)
    tri = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    cb = [mm(lowp, cm[:, j], bm[:, j].T) for j in range(g)]     # (S, S)
    xdt = xs * dt[..., None]
    y = torch.empty_like(xs)
    for h0 in range(0, hh, HEADS_AT_ONCE):
        hs = range(h0, min(hh, h0 + HEADS_AT_ONCE))
        diff = cum[:, None, h0:hs[-1] + 1] - cum[None, :, h0:hs[-1] + 1]
        decay = torch.exp(diff.masked_fill(~tri[..., None], -math.inf))
        for j, h in enumerate(hs):
            att = cb[h // (hh // g)] * decay[..., j].float()
            y[:, h] = mm(lowp, att, xdt[:, h])
    y = (y + xs * f[pre + "D"][:, None]).reshape(s, di) * F.silu(z)
    return mm(lowp, rmsnorm(y, f[pre + "norm.scale"], m["rms_norm_eps"]),
              f[pre + "out_proj.w"])


def attention(f, pre, x, m, lowp):
    s = x.shape[0]
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // hq
    q = mm(lowp, x, f[pre + "wq.w"]).reshape(s, hq, hd).transpose(0, 1)
    k = mm(lowp, x, f[pre + "wk.w"]).reshape(s, hkv, hd).transpose(0, 1)
    v = mm(lowp, x, f[pre + "wv.w"]).reshape(s, hkv, hd).transpose(0, 1)
    rep = hq // hkv
    tri = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    outs = []
    for h0 in range(0, hq, HEADS_AT_ONCE):
        qh = q[h0:h0 + HEADS_AT_ONCE]
        kh = k[torch.arange(h0, h0 + qh.shape[0]) // rep]
        vh = v[torch.arange(h0, h0 + qh.shape[0]) // rep]
        sc = mm(lowp, qh, kh.transpose(-1, -2)) * m["attention_multiplier"]
        sc = sc.masked_fill(~tri, float("-inf"))
        outs.append(mm(lowp, torch.softmax(sc, -1), vh))
    o = torch.cat(outs).transpose(0, 1).reshape(s, hq * hd)
    return mm(lowp, o, f[pre + "wo.w"])


def gated(f, pre, x, lowp):
    return mm(lowp, F.silu(mm(lowp, x, f[pre + "gate.w"])) *
              mm(lowp, x, f[pre + "up.w"]), f[pre + "down.w"])


def moe(f, pre, x, m, lowp):
    """The held experts' gated sum over the tokens x (T, d)."""
    k = m["top_k"]
    logits = x @ f[pre + "router"]
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, idx = torch.softmax(vals[:, :k], -1), idx[:, :k]
    y = torch.zeros_like(x)
    for j in range(f[pre + "w_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == j, as_tuple=True)
        if tok.numel():
            rows = x[tok]
            h = F.silu(mm(lowp, rows, f[pre + "w_gate"][j])) * \
                mm(lowp, rows, f[pre + "w_up"][j])
            y = y.index_add(0, tok, mm(lowp, h, f[pre + "w_down"][j])
                            * gates[tok, slot, None])
    return y


def layer(f, i, kind, x, m, lowp):
    """One layer over the sequences ``x`` (a list of (S_j, d))."""
    pre, eps, r = f"layers.{i}.", m["rms_norm_eps"], m["residual_multiplier"]
    mixer = mamba if kind == "mamba2" else attention
    sub = pre + ("mamba." if kind == "mamba2" else "attn.")
    x = [xj + r * mixer(f, sub, rmsnorm(xj, f[pre + "ln1.scale"], eps), m,
                        lowp) for xj in x]
    lens = [xj.shape[0] for xj in x]
    flat = torch.cat(x)
    h = rmsnorm(flat, f[pre + "ln2.scale"], eps)
    flat = flat + r * (moe(f, pre + "moe.", h, m, lowp) +
                       gated(f, pre + "shared.", h, lowp))
    return list(flat.split(lens))


def heads(f, x, m, lowp):
    x = [rmsnorm(xj, f["final_norm.scale"], m["rms_norm_eps"]) for xj in x]
    return [{"logits": mm(lowp, xj, f["embed.table"].T) / m["logits_scaling"],
             "value": (xj @ f["value_head.w"])[:, 0]} for xj in x]


def embed(f, seqs, m):
    return [f["embed.table"][s.long()] * m["embedding_multiplier"]
            for s in seqs]


def forward(m: dict, f: dict, seqs, lowp=None) -> list:
    """The whole model over each token sequence of ``seqs`` (1-D), with
    every weight in ``f`` (float32, or cast up here)."""
    f = {k: v.float() for k, v in f.items()}
    x = embed(f, seqs, m)
    for i, kind in enumerate(lay.kinds(m)):
        x = layer(f, i, kind, x, m, lowp)
    return heads(f, x, m, lowp)


def _draw(m: dict, lay_all: dict, paths, seed: int, device,
          dtype) -> dict:
    """The float32 values of ``paths``, as ``weights.make`` draws them in
    ``dtype`` (the served weights' rounding), drawing only the stream's
    chunks that overlap them; the mamba vectors as ``fill_vectors``."""
    runs, total = weights._runs(lay_all)
    mine = [r for r in runs if r[0] in paths]
    out = {}
    for p in paths:
        shape, std = lay_all[p]
        out[p] = torch.ones(shape, dtype=torch.float32, device=device) \
            if std is None else torch.empty(shape, dtype=dtype, device=device)
    if mine:
        lo = min(off for _, off, _, _ in mine)
        hi = max(off + n for _, off, n, _ in mine)
        with torch.no_grad():
            for c in range(lo // weights.CHUNK, -(-hi // weights.CHUNK)):
                n = min(weights.CHUNK, total - c * weights.CHUNK)
                gen = weights.generator(device, seed, 1, c)
                buf = torch.randn(n, generator=gen, device=device,
                                  dtype=torch.float32)
                for path, a, b, ca, cb, std in weights._overlaps(
                        mine, c * weights.CHUNK, n):
                    out[path].view(-1)[a:b].copy_(buf[ca:cb].mul_(std))
                del buf
    lay.fill_vectors(out, m)
    return {p: t.float() for p, t in out.items()}


@torch.no_grad()
def streamed(m: dict, seed: int, device, seqs, dtype, lowp=None) -> list:
    """``forward`` over ``seqs`` with the weights drawn from ``seed`` a
    layer at a time (the top-level leaves first, kept to the end)."""
    lay_all = lay.layout(m)
    top = [p for p in lay_all if not p.startswith("layers.")]
    f = _draw(m, lay_all, top, seed, device, dtype)
    x = embed(f, seqs, m)
    for i, kind in enumerate(lay.kinds(m)):
        pre = f"layers.{i}."
        fl = _draw(m, lay_all, [p for p in lay_all if p.startswith(pre)],
                   seed, device, dtype)
        x = layer(fl, i, kind, x, m, lowp)
        del fl
    return heads(f, x, m, lowp)


@torch.no_grad()
def gaps(m: dict, seed: int, device, requests, engine_seed: int, dtype,
         *, lowp=None) -> dict:
    """``reference/serve.py::gaps`` over the streamed forward:
    ``requests`` (rid, prompt, served tokens) -> {"served", "tokens"} and,
    with ``lowp``, "control"."""
    exact()
    seqs = [torch.as_tensor(list(p) + list(t)[:-1], device=device)
            for _, p, t in requests]
    if not seqs:
        return {"served": 0.0, "tokens": 0,
                **({"control": 0.0} if lowp is not None else {})}
    ref = streamed(m, seed, device, seqs, dtype)
    low = streamed(m, seed, device, seqs, dtype, lowp) \
        if lowp is not None else None
    worst, worst_low, n = 0.0, 0.0, 0
    for j, (rid, prompt, served) in enumerate(requests):
        plen = len(prompt)
        for i, tok in enumerate(served):
            lg = ref[j]["logits"][plen - 1 + i]
            g = threefry.token_noise(engine_seed, rid, plen + i,
                                     lg.shape[-1], lg.device)
            s = lg + g
            best = float(s.max())
            worst = max(worst, best - float(s[int(tok)]))
            if low is not None:
                pick = int(torch.argmax(low[j]["logits"][plen - 1 + i] + g))
                worst_low = max(worst_low, best - float(s[pick]))
            n += 1
    out = {"served": worst, "tokens": n}
    if lowp is not None:
        out["control"] = worst_low
    return out
