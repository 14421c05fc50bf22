"""The paper's agent networks (Mnih et al. 2013/2016, §5.1), as
``repro/models/atari.py``.

Conv 16x8x8/4 -> Conv 32x4x4/2 -> FC 256 -> heads; ReLU throughout.  Heads:
  * actor-critic: softmax policy + scalar value (shared trunk, Alg. 3)
  * value-based : one linear Q output per action (Alg. 1/2)
  * continuous  : Gaussian mean (linear) + variance (softplus) heads (§5.2.3)
  * recurrent   : an LSTM after the final hidden layer (A3C LSTM)
and the low-dimensional MLP agent (§5.2.3).

Parameters are nested dicts in the JAX package's layout: conv weights
HWIO, linear weights (d_in, d_out).  Observations are NHWC; ``F.conv2d``
takes NCHW/OIHW, so the trunk permutes at the call and permutes conv2's
output back to NHWC before the flatten, whose (H, W, C) order the FC rows
follow.  Initial weights are the reference's, drawn by ``prng`` from its
key tree (a normal truncated at +-2 times the stddev; within a few f32
ulps), biases zero.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.models.common import linear


def _trunc_normal(key, shape, stddev):
    return prng.truncated_normal(key, -2.0, 2.0, shape, scale=stddev)


def _init_conv(key, h, w, cin, cout):
    fan_in = h * w * cin
    return {"w": _trunc_normal(key, (h, w, cin, cout), (1.0 / fan_in) ** 0.5),
            "b": torch.zeros((cout,), device=key.device)}


def _init_linear(key, d_in, d_out, *, bias=False, stddev=None):
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _trunc_normal(key, (d_in, d_out), stddev)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=key.device)
    return p


def _conv(p, x, stride):
    """x (N, C, H, W); p["w"] HWIO."""
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride)


def init_atari_params(key: torch.Tensor, n_actions: int, *,
                      input_hw: int = 84, in_channels: int = 4,
                      lstm: bool = False, continuous: bool = False,
                      device=None) -> Dict[str, Any]:
    """The conv agent from ``key`` (a ``prng`` key), on ``device`` (the
    card unless given)."""
    ks = prng.split(key.to(resolve(device)), 8)
    p: Dict[str, Any] = {
        "conv1": _init_conv(ks[0], 8, 8, in_channels, 16),
        "conv2": _init_conv(ks[1], 4, 4, 16, 32),
    }
    # conv output size for 84x84: ((84-8)/4+1)=20 -> ((20-4)/2+1)=9 -> 9*9*32
    h1 = (input_hw - 8) // 4 + 1
    h2 = (h1 - 4) // 2 + 1
    p["fc"] = _init_linear(ks[2], h2 * h2 * 32, 256, bias=True)
    d = 256
    if lstm:
        p["lstm"] = {"wx": _init_linear(ks[3], 256, 4 * 256, bias=True),
                     "wh": _init_linear(ks[4], 256, 4 * 256)}
    if continuous:
        p["mu"] = _init_linear(ks[5], d, n_actions, bias=True, stddev=1e-2)
        p["sigma"] = _init_linear(ks[6], d, 1, bias=True, stddev=1e-2)
    else:
        p["policy"] = _init_linear(ks[5], d, n_actions, bias=True,
                                   stddev=1e-2)
    p["value"] = _init_linear(ks[7], d, 1, bias=True, stddev=1e-2)
    return p


def init_mlp_agent_params(key: torch.Tensor, obs_dim: int, n_actions: int,
                          *, hidden: int = 200, lstm: bool = False,
                          lstm_size: int = 128, continuous: bool = False,
                          device=None) -> Dict[str, Any]:
    """Low-dimensional agent: 200 ReLU -> (128 LSTM) -> heads (§5.2.3)."""
    ks = prng.split(key.to(resolve(device)), 8)
    p: Dict[str, Any] = {"fc": _init_linear(ks[0], obs_dim, hidden,
                                            bias=True)}
    d = hidden
    if lstm:
        p["lstm"] = {"wx": _init_linear(ks[1], hidden, 4 * lstm_size,
                                        bias=True),
                     "wh": _init_linear(ks[2], lstm_size, 4 * lstm_size)}
        d = lstm_size
    if continuous:
        p["mu"] = _init_linear(ks[3], d, n_actions, bias=True, stddev=1e-2)
        p["sigma"] = _init_linear(ks[4], d, 1, bias=True, stddev=1e-2)
    else:
        p["policy"] = _init_linear(ks[3], d, n_actions, bias=True,
                                   stddev=1e-2)
    p["value"] = _init_linear(ks[5], d, 1, bias=True, stddev=1e-2)
    return p


def lstm_cell(p, x, state):
    """Standard LSTM, gates i, f, g, o, +1 on the forget gate.  state =
    (h, c)."""
    h, c = state
    gates = linear(p["wx"], x) + linear(p["wh"], h)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def init_lstm_state(batch: int, size: int = 256, device=None):
    z = torch.zeros((batch, size), device=resolve(device))
    return (z, z)


def trunk(params, obs, lstm_state=None):
    """obs (B, H, W, C) pixels in [0, 1] or (B, obs_dim) low-dim state."""
    if obs.dim() == 4:
        x = torch.relu(_conv(params["conv1"], obs.permute(0, 3, 1, 2), 4))
        x = torch.relu(_conv(params["conv2"], x, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(linear(params["fc"], x))
    else:
        x = torch.relu(linear(params["fc"], obs))
    if "lstm" in params:
        if lstm_state is None:
            lstm_state = init_lstm_state(x.shape[0],
                                         params["lstm"]["wh"]["w"].shape[0],
                                         x.device)
        x, lstm_state = lstm_cell(params["lstm"], x, lstm_state)
    return x, lstm_state


def actor_critic_heads(params, feats) -> Dict[str, torch.Tensor]:
    """Discrete A3C heads: logits + value."""
    return {"logits": linear(params["policy"], feats),
            "value": linear(params["value"], feats)[..., 0]}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def gaussian_heads(params, feats) -> Dict[str, torch.Tensor]:
    """Continuous A3C heads (§5.2.3): mu linear, sigma^2 = softplus."""
    return {"mu": linear(params["mu"], feats),
            "sigma2": softplus(linear(params["sigma"], feats))[..., 0] + 1e-4,
            "value": linear(params["value"], feats)[..., 0]}


def q_heads(params, feats) -> torch.Tensor:
    """Value-based methods: one linear output per action."""
    return linear(params["policy"], feats)

