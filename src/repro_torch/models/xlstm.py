"""xLSTM blocks, as ``repro/models/xlstm.py``: mLSTM (matrix memory,
chunk-parallel in training) and sLSTM (scalar memory, a true recurrence),
per Beck et al. 2024 (arXiv:2405.04517).

The mLSTM training pass is the chunkwise form of the reference: the
exponential gates' running stabiliser m makes log-space decays, the
within-chunk part is einsums, and a Python loop carries the (C, n, m)
chunk states (``lax.scan`` there).  sLSTM has a recurrent matrix inside
its gates, so training loops over time.  All plain PyTorch (the reference
has no kernel here); the norms inside the blocks are ``common.rmsnorm``,
kernel 1 on the card.

Under tensor parallelism (``tp``) a rank runs its H / tp heads.  The
mLSTM's ``up_x``/``up_z`` and conv are column-parallel; its conv output
and ``xi`` are all-gathered along the features for ``wq``/``wk``/``wv``
(this rank's heads' columns) and the whole ``w_i``/``w_f`` (narrowed to
this rank's heads, their gradients summed over the model group); its norm
runs on rows gathered along the features (``common.rmsnorm_features``).
The sLSTM's ``w_in`` columns are head-major, so its contiguous split is
this rank's heads' gate blocks, and ``r`` is split over the heads
(``sharding.tp_splits``): the recurrence needs no collective; its output
is gathered along the features before the block's norm and
feed-forward, whose ``ff_down`` returns partial sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.models.ssm import causal_conv

# the mLSTM state's stabiliser starts at this finite sentinel, as the
# reference's: a -inf start would make the first chunk's -inf - -inf NaN
M_INIT = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_shapes(d_model: int, *, n_heads: int, expand: int = 2,
                 conv_width: int = 4) -> dict:
    """``init_mlstm``'s layout."""
    di = expand * d_model
    return {"up_x": {"w": (d_model, di)}, "up_z": {"w": (d_model, di)},
            "conv_w": (conv_width, di), "conv_b": (di,),
            "wq": {"w": (di, di)}, "wk": {"w": (di, di)},
            "wv": {"w": (di, di)},
            "w_i": {"w": (di, n_heads), "b": (n_heads,)},
            "w_f": {"w": (di, n_heads), "b": (n_heads,)},
            "norm": {"scale": (di,)}, "down": {"w": (di, d_model)}}


def mlstm_chunked(q, k, v, log_f, log_i, *, chunk: int, state=None):
    """Chunkwise mLSTM with the exponential-gating stabiliser.

    q, k, v (B, S, H, D); log_f, log_i (B, S, H).  Returns (y (B, S, H, D)
    f32, (C, n, m) the final state).  C_t = f_t C_{t-1} + i_t v_t k_t^T,
    n_t = f_t n_{t-1} + i_t k_t, y_t = C_t q_t / max(|n_t . q_t|,
    exp(-m_t)), every gate stabilised by m_t = max(log f_t + m_{t-1},
    log i_t).  The within-chunk mask is -inf, the state's m starts at
    ``M_INIT``."""
    bsz, s, h, d = q.shape
    qc = min(chunk, s)
    if s % qc:
        raise ValueError(f"seq {s} not divisible by chunk {qc}")
    nc = s // qc

    def r(t):
        return t.float().reshape((bsz, nc, qc) + tuple(t.shape[2:]))

    q, k, v, log_f, log_i = r(q), r(k), r(v), r(log_f), r(log_i)
    cum_f = torch.cumsum(log_f, dim=2)                   # (B,nc,q,H)
    total_f = cum_f[:, :, -1]                            # (B,nc,H)

    # within-chunk weights exp(cum_i - cum_j + log_i_j), causal
    logw = (cum_f[:, :, :, None] - cum_f[:, :, None, :]
            + log_i[:, :, None, :, :])                   # (B,nc,i,j,H)
    mask = torch.tril(torch.ones((qc, qc), dtype=torch.bool,
                                 device=q.device))
    logw = torch.where(mask[None, None, :, :, None], logw,
                       torch.full((), -torch.inf, device=q.device))
    m_loc = logw.amax(dim=3)                             # (B,nc,i,H)
    # chunk-state weights exp(total_f - cum_f_j + log_i_j)
    logs = total_f[:, :, None] - cum_f + log_i           # (B,nc,j,H)

    scale = d ** -0.5
    qk = torch.einsum("bcihd,bcjhd->bcijh", q, k) * scale

    if state is None:
        c_prev = torch.zeros((bsz, h, d, d), dtype=torch.float32,
                             device=q.device)
        n_prev = torch.zeros((bsz, h, d), dtype=torch.float32,
                             device=q.device)
        m_prev = torch.full((bsz, h), M_INIT, dtype=torch.float32,
                            device=q.device)
    else:
        c_prev, n_prev, m_prev = state

    ys = []
    for ci in range(nc):
        qi, ki, vi = q[:, ci], k[:, ci], v[:, ci]
        qki, logwi, logsi = qk[:, ci], logw[:, ci], logs[:, ci]
        cumfi, toti, mloci = cum_f[:, ci], total_f[:, ci], m_loc[:, ci]
        # the stabiliser per row i: inherited m decayed, or the local max
        m_inh = m_prev[:, None, :] + cumfi               # (B,i,H)
        m_row = torch.maximum(m_inh, mloci)
        w_loc = torch.exp(logwi - m_row[:, :, None, :])  # (B,i,j,H)
        w_inh = torch.exp(m_inh - m_row)                 # (B,i,H)
        num_loc = torch.einsum("bijh,bijh,bjhd->bihd", qki, w_loc, vi)
        # C is stored (v index d, k index e): q contracts the k index
        num_inh = torch.einsum("bihe,bhde->bihd",
                               qi * w_inh[..., None] * scale, c_prev)
        nq_loc = torch.einsum("bijh,bijh->bih", qki, w_loc)
        nq_inh = torch.einsum("bihd,bhd->bih", qi * scale, n_prev) * w_inh
        den = torch.maximum((nq_loc + nq_inh).abs(), torch.exp(-m_row))
        ys.append((num_loc + num_inh) / den[..., None])
        # the chunk state, stabilised by the new m at the chunk's end
        m_end = torch.maximum(m_prev + toti, logsi.amax(dim=1))
        s_w = torch.exp(logsi - m_end[:, None, :])       # (B,j,H)
        decay = torch.exp(m_prev + toti - m_end)
        c_prev = (decay[:, :, None, None] * c_prev
                  + torch.einsum("bjh,bjhd,bjhe->bhde", s_w, vi, ki))
        n_prev = (decay[:, :, None] * n_prev
                  + torch.einsum("bjh,bjhd->bhd", s_w, ki))
        m_prev = m_end
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, d)
    return y, (c_prev, n_prev, m_prev)


def _mlstm_inputs(p: dict, x: torch.Tensor, conv_state=None):
    """The projections of an mLSTM block: (xi, z, xc, the conv state)."""
    xi = cm.linear(p["up_x"], x)
    z = cm.linear(p["up_z"], x)
    xc, conv_state = causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    return xi, z, cm.silu(xc), conv_state


def _local_heads(p: dict, h: int, tp) -> dict:
    """Whole leaves narrowed to this rank's ``h`` heads (their last dim),
    each gradient summed over the model group: each rank's covers its own
    heads."""
    return {k: collectives.sum_grads(t, tp.group).narrow(-1, tp.rank * h, h)
            for k, t in p.items()}


def mlstm_train(p: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """x (B, S, d_model) -> (B, S, d_model).  Under tensor parallelism
    (``tp``, ``fsdp.TPRule``) x is the whole sequence, ``p`` this rank's
    leaves, and the result this rank's partial sums of ``down`` (the
    ``tp_lstm_heads`` route)."""
    bsz, s, _ = x.shape
    hd = cfg.lstm_expand * cfg.d_model // cfg.n_heads
    xi, z, xc, _ = _mlstm_inputs(p, x)
    d_loc = xi.shape[-1]
    h = d_loc // hd
    gates = {"w_i": p["w_i"], "w_f": p["w_f"]}
    xc_all, xi_all = xc, xi
    if tp is not None:
        dispatch.count_route("tp_lstm_heads")
        both = collectives.gather_sum(torch.stack([xc, xi]), tp.group, 3)
        xc_all, xi_all = both[0], both[1]
        gates = {k: _local_heads(g, h, tp) for k, g in gates.items()}
    q = cm.linear(p["wq"], xc_all).reshape(bsz, s, h, hd)
    k = cm.linear(p["wk"], xc_all).reshape(bsz, s, h, hd)
    v = cm.linear(p["wv"], xi_all).reshape(bsz, s, h, hd)
    log_i = cm.linear(gates["w_i"], xc_all).float()              # (B,S,H)
    log_f = F.logsigmoid(cm.linear(gates["w_f"], xc_all).float())
    y, _ = mlstm_chunked(q, k, v, log_f, log_i, chunk=cfg.ssm_chunk)
    y = y.to(x.dtype).reshape(bsz, s, d_loc)
    y = cm.rmsnorm_features(p["norm"], y, tp) * cm.silu(z)
    return cm.linear(p["down"], y)


def init_mlstm_state(batch: int, d_model: int, n_heads: int, *,
                     expand: int = 2, conv_width: int = 4,
                     device=None) -> dict:
    """{"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H) at ``M_INIT``,
    "conv": (B, W-1, d_inner)}, all f32."""
    d_inner = expand * d_model
    hd = d_inner // n_heads

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"C": z(batch, n_heads, hd, hd), "n": z(batch, n_heads, hd),
            "m": torch.full((batch, n_heads), M_INIT, dtype=torch.float32,
                            device=device),
            "conv": z(batch, conv_width - 1, d_inner)}


def mlstm_decode(p: dict, x: torch.Tensor, state: dict, cfg, tp=None):
    """One-token decode.  x (B, 1, d_model) -> (y, state), the state
    written in place.  Under the serving layout (``tp``) ``p`` holds this
    rank's heads and the state theirs (its conv state this rank's
    channels): the conv output and ``xi`` are all-gathered along the
    features, ``w_i``/``w_f`` narrowed to the rank's heads, the norm on
    feature-gathered rows, and y is this rank's partial sum of ``down``
    (the ``tp_lstm_heads`` route)."""
    bsz = x.shape[0]
    hd = cfg.lstm_expand * cfg.d_model // cfg.n_heads
    xi, z, xc, conv_state = _mlstm_inputs(p, x, state["conv"])
    d_loc = xi.shape[-1]
    h = d_loc // hd
    gates = {"w_i": p["w_i"], "w_f": p["w_f"]}
    xc_all, xi_all = xc, xi
    if tp is not None:
        dispatch.count_route("tp_lstm_heads")
        both = collectives.gather_slice(torch.stack([xc, xi]), tp.group, 3)
        xc_all, xi_all = both[0], both[1]
        gates = {k: _local_heads(g, h, tp) for k, g in gates.items()}
    q = cm.linear(p["wq"], xc_all).reshape(bsz, h, hd).float()
    k = cm.linear(p["wk"], xc_all).reshape(bsz, h, hd).float()
    v = cm.linear(p["wv"], xi_all).reshape(bsz, h, hd).float()
    log_i = cm.linear(gates["w_i"], xc_all)[:, 0].float()        # (B,H)
    log_f = F.logsigmoid(cm.linear(gates["w_f"], xc_all))[:, 0].float()

    m_new = torch.maximum(log_f + state["m"], log_i)
    f_s = torch.exp(log_f + state["m"] - m_new)
    i_s = torch.exp(log_i - m_new)
    c_new = f_s[:, :, None, None] * state["C"] + \
        i_s[:, :, None, None] * torch.einsum("bhd,bhe->bhde", v, k)
    n_new = f_s[:, :, None] * state["n"] + i_s[:, :, None] * k
    scale = hd ** -0.5
    num = torch.einsum("bhde,bhe->bhd", c_new, q * scale)
    den = torch.maximum(
        torch.einsum("bhd,bhd->bh", n_new, q * scale).abs(),
        torch.exp(-m_new))
    y = (num / den[:, :, None]).to(x.dtype).reshape(bsz, 1, d_loc)
    y = cm.rmsnorm_features(p["norm"], y, tp) * cm.silu(z)
    out = cm.linear(p["down"], y)
    for name, new in (("C", c_new), ("n", n_new), ("m", m_new),
                      ("conv", conv_state)):
        state[name].copy_(new)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_d_ff(d_model: int, ff_factor: float = 4 / 3) -> int:
    """The feed-forward width, rounded down to a multiple of 64 (at least
    64), as ``init_slstm``."""
    return max(64, (int(ff_factor * d_model) // 64) * 64)


def slstm_shapes(d_model: int, *, n_heads: int) -> dict:
    """``init_slstm``'s layout."""
    hd = d_model // n_heads
    d_ff = slstm_d_ff(d_model)
    return {"w_in": {"w": (d_model, 4 * d_model), "b": (4 * d_model,)},
            "r": (n_heads, hd, 4 * hd), "norm": {"scale": (d_model,)},
            "ff_gate": {"w": (d_model, d_ff)}, "ff_up": {"w": (d_model, d_ff)},
            "ff_down": {"w": (d_ff, d_model)}}


def init_slstm_state(batch: int, d_model: int, n_heads: int,
                     device=None) -> dict:
    """{"h", "c": zeros, "n": ones, "m": zeros}, each (B, H, hd) f32."""
    hd = d_model // n_heads
    shape = (batch, n_heads, hd)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.ones(shape, device=device),
            "m": torch.zeros(shape, device=device)}


def slstm_step(p: dict, state: dict, xt: torch.Tensor, n_heads: int) -> dict:
    """xt (B, 4 d_model), the input's preactivations; the recurrent part
    is added here.  Returns the new state (a new dict)."""
    bsz = xt.shape[0]
    hd = state["h"].shape[-1]
    rec = torch.einsum("bhd,hde->bhe", state["h"], p["r"].float())
    pre = xt.reshape(bsz, n_heads, 4 * hd).float() + rec
    zi, ii, fi, oi = torch.split(pre, hd, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    # exponential input gate, log-sigmoid forget gate, stabiliser m
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + state["m"], ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c_new = f_s * state["c"] + i_s * zt
    n_new = f_s * state["n"] + i_s
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def _slstm_out(p: dict, y: torch.Tensor, tp=None) -> torch.Tensor:
    """The block's norm and gated feed-forward.  Under tensor parallelism
    y is this rank's heads' features: gathered along them first, the norm
    on whole rows (its whole scale's gradient summed over the model group:
    each rank's cotangent reaches it through its own d_ff columns only),
    ``ff_down`` this rank's partial sums."""
    norm = p["norm"]
    if tp is not None:
        dispatch.count_route("tp_feature_rows")
        y = collectives.gather_sum(y, tp.group, 2)
        norm = {"scale": collectives.sum_grads(norm["scale"], tp.group)}
    y = cm.rmsnorm(norm, y)
    return cm.linear(p["ff_down"], cm.gelu(cm.linear(p["ff_gate"], y))
                     * cm.linear(p["ff_up"], y))


def slstm_train(p: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """The recurrence over time, one step a position.  x (B, S, d).  Under
    tensor parallelism (``tp``) x is the whole sequence and this rank runs
    the recurrence of its heads (``r``'s first dim), ``w_in``'s whole bias
    narrowed to their columns (its gradient summed over the model group);
    the result is this rank's partial sums (the ``tp_lstm_heads``
    route)."""
    bsz, s, _ = x.shape
    w_in = p["w_in"]
    if tp is not None:
        dispatch.count_route("tp_lstm_heads")
        n = w_in["w"].shape[1]
        w_in = {"w": w_in["w"], "b": collectives.sum_grads(
            w_in["b"], tp.group).narrow(0, tp.rank * n, n)}
    h, hd = p["r"].shape[:2]
    pre = cm.linear(w_in, x)                              # (B,S,4 h hd)
    st = init_slstm_state(bsz, h * hd, h, x.device)
    hs = []
    for t in range(s):
        st = slstm_step(p, st, pre[:, t], h)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).reshape(bsz, s, h * hd).to(x.dtype)
    return _slstm_out(p, y, tp)


def slstm_decode(p: dict, x: torch.Tensor, state: dict, cfg, tp=None):
    """One-token decode; the state written in place.  Under the serving
    layout (``tp``) the recurrence runs on this rank's heads (``r``'s
    first dim, ``w_in``'s head-major columns with its whole bias narrowed
    to them) and the state holds theirs; y is this rank's partial sum of
    ``ff_down`` (the ``tp_lstm_heads`` route)."""
    bsz = x.shape[0]
    w_in = p["w_in"]
    if tp is not None:
        dispatch.count_route("tp_lstm_heads")
        n = w_in["w"].shape[1]
        w_in = {"w": w_in["w"], "b": w_in["b"].narrow(0, tp.rank * n, n)}
    h, hd = p["r"].shape[:2]
    pre = cm.linear(w_in, x)[:, 0]
    st = slstm_step(p, state, pre, h)
    y = st["h"].reshape(bsz, 1, h * hd).to(x.dtype)
    for name, new in st.items():
        state[name].copy_(new)
    return _slstm_out(p, y, tp), state
