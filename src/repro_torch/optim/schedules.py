"""Learning-rate schedules and per-worker hyperparameter sampling, as
``repro/optim/schedules.py``.

The paper anneals lr linearly to 0 over training and samples the initial
lr per experiment from LogUniform(1e-4, 1e-2) (§5.1); MiniCPM's
warmup-stable-decay schedule comes with the minicpm-2b config.  A schedule
returns a host float computed in f32, the arithmetic of the JAX package's
schedules, so the kernels take lr by value and nothing waits on the
device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import prng

_F = np.float32


def linear_anneal(lr0: float, step, total_steps) -> float:
    frac = np.clip(_F(1.0) - _F(step) / _F(total_steps), _F(0.0), _F(1.0))
    return float(_F(lr0) * frac)


def log_uniform(key: torch.Tensor, lo: float = 1e-4, hi: float = 1e-2,
                shape=(), *, partitionable: bool = True) -> torch.Tensor:
    """exp(log lo + u * (log hi - log lo)) in f32, u = ``prng.uniform(key,
    shape)``: the JAX package's draw from ``jax.random.uniform(key)``, on
    the key's device."""
    u = prng.uniform(key, shape, partitionable=partitionable)
    log_lo = torch.tensor(_F(math.log(lo)), device=u.device)
    log_hi = torch.tensor(_F(math.log(hi)), device=u.device)
    return torch.exp(log_lo + u * (log_hi - log_lo))


def wsd(lr0: float, step, total_steps, *, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, floor: float = 0.1) -> float:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4)."""
    step, lr0 = _F(step), _F(lr0)
    warm = _F(warmup_frac * total_steps)
    decay_start = _F((1.0 - decay_frac) * total_steps)
    if step < warm:
        return float(lr0 * step / max(warm, _F(1.0)))
    if step < decay_start:
        return float(lr0)
    decay_t = (step - decay_start) / max(_F(total_steps) - decay_start,
                                         _F(1.0))
    return float(lr0 * _F(floor) ** np.clip(decay_t, _F(0.0), _F(1.0)))


SCHEDULES = {"linear": linear_anneal, "wsd": wsd,
             "constant": lambda lr0, step, total: float(_F(lr0))}
