"""Mamba2 (SSD) block, as ``repro/models/ssm.py``.

Training takes the chunked SSD decomposition (Dao & Gu 2024, §6): within
a chunk of Q steps the recurrence is a masked, decayed product of
einsums; across chunks a short loop carries the chunk states (a Python
loop here, ``lax.scan`` there).  The serve engine's admission runs a
prompt chunk through the same scan from each row's carried state
(``mamba2_prefill``).  Decode is the O(1) recurrence
``h <- a h + dt B (x)  x;  y = C . h + D x``.  Everything is plain
PyTorch: the reference has no kernel here, and its gated norm is
``common.rmsnorm``, kernel 1 on the card.

Under tensor parallelism (``mamba2_train``'s ``tp``) a rank holds its
heads: its 1/tp of z, x and dt in ``in_proj``, of A_log, D, dt_bias and
the norm's scale, and 1/tp of B and C (``sharding.tp_splits``' blocked
``in_proj`` and conv).  B and C are all-gathered after the conv, since
every head reads its group's whole maps; the gated norm runs on rows
gathered along the features (``common.rmsnorm_features``); ``out_proj``
returns this rank's partial sums.
"""
from __future__ import annotations

from typing import Optional

import math

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm

# elements of the (rows, q, q, heads) f32 products a prefill chunk's scan
# makes at once (512 MB): an admission of many rows runs its scan a block
# of rows at a time, each row's scan being its own
SCAN_ELEMS = 1 << 27


def mamba2_shapes(d_model: int, *, d_state: int, n_heads: int,
                  head_dim: int, n_groups: int = 1,
                  conv_width: int = 4) -> dict:
    """``init_mamba2``'s layout; d_inner = n_heads * head_dim."""
    d_inner = n_heads * head_dim
    d_in_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    conv_ch = d_inner + 2 * n_groups * d_state
    return {"in_proj": {"w": (d_model, d_in_proj)},
            "conv_w": (conv_width, conv_ch), "conv_b": (conv_ch,),
            "A_log": (n_heads,), "D": (n_heads,), "dt_bias": (n_heads,),
            "norm": {"scale": (d_inner,)},
            "out_proj": {"w": (d_inner, d_model)}}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, logaddexp(x, 0) (``F.softplus`` turns linear
    above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_in_proj(z_all, d_inner, gn):
    """z | x | B | C | dt of in_proj's output (d_inner the z and x width,
    gn the B and C width: this rank's under tensor parallelism)."""
    zi = d_inner
    xi = 2 * d_inner
    bi = xi + gn
    ci = bi + gn
    return (z_all[..., :zi], z_all[..., zi:xi], z_all[..., xi:bi],
            z_all[..., bi:ci], z_all[..., ci:])


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                ends: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x (B, S, C), w (W, C); ``state`` the last
    W-1 inputs before x (zeros without it).  Returns (y in x's dtype, the
    new state: the last W-1 inputs; with ``ends`` (B,), each row's count
    of real inputs in x, the W-1 inputs before row b's ends[b]-th)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    if ends is not None and width > 1:
        at = ends[:, None] + torch.arange(width - 1, device=x.device)
        new_state = xp.gather(1, at[:, :, None].expand(-1, -1, xp.shape[2]))
    else:
        new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y.to(x.dtype), new_state


def ssd_chunked(x, log_a, b, c, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x     (B, S, H, P)   per-head inputs (already dt-scaled)
    log_a (B, S, H)      per-step log decay (<= 0)
    b     (B, S, H, N)   input maps (group-expanded)
    c     (B, S, H, N)   output maps
    Returns (y (B, S, H, P) f32, h_last (B, H, N, P) f32).  The einsums
    take f32 operands, the reference's ``preferred_element_type``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc = s // q

    def r(t):  # (B, S, ...) -> (B, nc, q, ...)
        return t.float().reshape((bsz, nc, q) + tuple(t.shape[2:]))

    x, log_a, b, c = r(x), r(log_a), r(b), r(c)
    cum = torch.cumsum(log_a, dim=2)                      # (B,nc,q,H)
    total = cum[:, :, -1]                                 # (B,nc,H)

    # within-chunk: Y_diag[i] = sum_{j<=i} exp(cum_i - cum_j) (c_i.b_j) x_j.
    # The mask goes on the exponent (exp(-inf) = 0), not on the product as
    # in the reference: above the diagonal cum_i - cum_j >= 0 overflows f32
    # at full-size chunks (256 steps of dt * a reach far past 88), and
    # where(mask, inf, 0)'s backward is 0 * inf = NaN.  The forward values
    # are the reference's.
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(
        mask[None, None, :, :, None], cum[:, :, :, None] - cum[:, :, None, :],
        torch.full((), -torch.inf, device=x.device)))    # (B,nc,i,j,H)
    cb = torch.einsum("bcihn,bcjhn->bcijh", c, b)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, x)

    # chunk states: S_c = sum_j exp(total - cum_j) b_j (x) x_j
    w = torch.exp(total[:, :, None] - cum)                # (B,nc,q,H)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", b, w, x)

    # cross-chunk recurrence over the chunk states
    hh = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(hh)
        hh = torch.exp(total[:, ci])[:, :, None, None] * hh + states[:, ci]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,nc,H,N,P)

    # off-chunk contribution: Y_off[i] = c_i . (exp(cum_i) * h_prev_chunk)
    y_off = torch.einsum("bcihn,bcih,bchnp->bcihp", c, torch.exp(cum),
                         h_prevs)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, hh


def _conv_split(p: dict, xin: torch.Tensor, state=None, ends=None):
    """in_proj, the causal conv and its silu; returns (z, xs, bb, cc, dt,
    the conv state, taken at each row's ``ends`` where given).  The
    widths are the leaves' own (this rank's parts under tensor
    parallelism)."""
    d_inner = p["norm"]["scale"].shape[0]
    gn = (p["conv_w"].shape[1] - d_inner) // 2
    z, xs, bb, cc, dt = _split_in_proj(cm.linear(p["in_proj"], xin),
                                       d_inner, gn)
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                       state, ends)
    conv_out = cm.silu(conv_out)
    return (z, conv_out[..., :d_inner],
            conv_out[..., d_inner:d_inner + gn],
            conv_out[..., d_inner + gn:], dt, conv_state)


def mamba2_train(p: dict, xin: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """xin (B, S, d_model) -> (B, S, d_model).  Under tensor parallelism
    (``tp``, ``fsdp.TPRule``) xin is the whole sequence, ``p`` this rank's
    leaves (its H / tp heads, counted from ``A_log``), and the result this
    rank's partial sums of ``out_proj`` (the ``tp_ssm_heads`` route)."""
    pd, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h = p["A_log"].shape[0]
    z, xs, bb, cc, dt, _ = _conv_split(p, xin)
    if tp is not None:
        dispatch.count_route("tp_ssm_heads")
        # every head reads its group's whole B and C: gathered along the
        # features, the backward summing the ranks' partial cotangents
        bc = collectives.gather_sum(torch.stack([bb, cc]), tp.group, 3)
        bb, cc = bc[0], bc[1]
    bsz, s = xin.shape[:2]
    xs = xs.reshape(bsz, s, h, pd)
    rep = cfg.ssm_heads // g
    bb = bb.reshape(bsz, s, g, n).repeat_interleave(rep, dim=2)
    cc = cc.reshape(bsz, s, g, n).repeat_interleave(rep, dim=2)
    if h < cfg.ssm_heads:
        bb, cc = (t.narrow(2, tp.rank * h, h) for t in (bb, cc))

    dt = softplus(dt.float() + p["dt_bias"])                     # (B,S,H)
    a = -torch.exp(p["A_log"])                                   # (H,)
    log_decay = dt * a
    x_dt = xs * dt[..., None].to(xs.dtype)

    y, _ = ssd_chunked(x_dt, log_decay, bb, cc, chunk=cfg.ssm_chunk)
    return _gated_out(p, y, xs, z, cfg, tp)


def _gated_out(p: dict, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
               cfg, tp=None) -> torch.Tensor:
    """The scan's output (B, S, H, P) f32 plus the D skip, the gated norm
    and ``out_proj``."""
    bsz, s = y.shape[:2]
    y = y.to(xs.dtype) + xs * p["D"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, -1)
    y = cm.rmsnorm_features(p["norm"], y * cm.silu(z), tp,
                            eps=cfg.rms_norm_eps)
    return cm.linear(p["out_proj"], y)


def mamba2_prefill(p: dict, xin: torch.Tensor, state: dict, cfg,
                   pos0: int, true_len: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """One prompt chunk of the serve engine's admission: xin (B, C,
    d_model) at positions [pos0, pos0 + C) of right-padded prompts whose
    real lengths are ``true_len`` (B,; None: every position real).  The scan starts from each row's
    ``h`` and conv state in ``state`` (from zeros at pos0 0, whatever the
    rows held before) and writes back each row's state after its own last
    real position: a padded position takes dt = 0, so its decay is 1 and
    its input 0 and ``h`` passes it unchanged, and the conv state is the
    W-1 inputs before the row's end.  The scan's chunk is the config's,
    or the largest that divides C; it runs over blocks of rows whose
    (rows, q, q, H) products hold at most ``SCAN_ELEMS`` elements.
    Returns the mixer's output (B, C, d_model); the padded positions' rows
    are finite and meaningless."""
    pd, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h = p["A_log"].shape[0]
    bsz, c = xin.shape[:2]
    first = pos0 == 0
    if true_len is None:
        ends = torch.full((bsz,), c, device=xin.device)
    else:
        ends = (true_len.to(xin.device).long() - pos0).clamp(0, c)
    z, xs, bb, cc, dt, conv = _conv_split(
        p, xin, None if first else state["conv"], ends)
    xs = xs.reshape(bsz, c, h, pd)
    bb, cc = (t.reshape(bsz, c, g, n) for t in (bb, cc))
    real = torch.arange(c, device=xin.device)[None, :] < ends[:, None]
    dt = torch.where(real[..., None], softplus(dt.float() + p["dt_bias"]),
                     0.0)                                        # (B,C,H)
    x_dt, log_decay = xs * dt[..., None].to(xs.dtype), dt * -torch.exp(
        p["A_log"])
    q = math.gcd(c, cfg.ssm_chunk)
    step = max(1, SCAN_ELEMS // (q * q * h))
    ys = []
    for r in range(0, bsz, step):
        rows = slice(r, r + step)
        y, hh = ssd_chunked(
            x_dt[rows], log_decay[rows],
            bb[rows].repeat_interleave(h // g, dim=2),
            cc[rows].repeat_interleave(h // g, dim=2), chunk=q,
            h0=None if first else state["h"][rows])
        ys.append(y)
        state["h"][rows] = hh
    state["conv"].copy_(conv)
    return _gated_out(p, torch.cat(ys) if len(ys) > 1 else ys[0], xs, z,
                      cfg)


def init_mamba2_state(batch: int, cfg, dtype=torch.float32,
                      device=None) -> dict:
    """{"h": (B, H, N, P) f32, "conv": (B, W-1, conv channels) dtype}."""
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    conv_ch = h * pd + 2 * g * n
    return {"h": torch.zeros((batch, h, n, pd), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}


def mamba2_decode(p: dict, xin: torch.Tensor, state: dict, cfg, tp=None):
    """One-token decode.  xin (B, 1, d_model) -> (y, state), the state
    written in place.  Under the serving layout (``tp``) ``p`` holds this
    rank's heads and the state its heads' ``h`` and its parts of the conv
    channels (``sharding.cache_shardings``); B and C are all-gathered
    after the conv, the gated norm runs on feature-gathered rows, and y is
    this rank's partial sum of ``out_proj`` (the ``tp_ssm_heads``
    route)."""
    pd, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    h = p["A_log"].shape[0]
    d_inner = h * pd
    z, xs, bb, cc, dt, conv_state = _conv_split(p, xin, state["conv"])
    if tp is not None:
        dispatch.count_route("tp_ssm_heads")
        bc = collectives.gather_slice(torch.stack([bb, cc]), tp.group, 3)
        bb, cc = bc[0], bc[1]
    bsz = xin.shape[0]
    xs = xs.reshape(bsz, h, pd)
    rep = cfg.ssm_heads // g
    bb = bb.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
    cc = cc.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
    if h < cfg.ssm_heads:
        bb, cc = (t.narrow(1, tp.rank * h, h) for t in (bb, cc))
    dt = softplus(dt[:, 0].float() + p["dt_bias"])               # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                   # (B,H)

    hh = a[:, :, None, None] * state["h"] + torch.einsum(
        "bhn,bh,bhp->bhnp", bb.float(), dt, xs.float())
    y = torch.einsum("bhn,bhnp->bhp", cc.float(), hh)
    y = y.to(xin.dtype) + xs * p["D"].to(xs.dtype)[None, :, None]
    y = y.reshape(bsz, 1, d_inner)
    y = cm.rmsnorm_features(p["norm"], y * cm.silu(z), tp,
                            eps=cfg.rms_norm_eps)
    state["h"].copy_(hh)
    state["conv"].copy_(conv_state)
    return cm.linear(p["out_proj"], y), state
