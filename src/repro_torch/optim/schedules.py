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

_F = np.float32


def linear_anneal(lr0: float, step, total_steps) -> float:
    frac = np.clip(_F(1.0) - _F(step) / _F(total_steps), _F(0.0), _F(1.0))
    return float(_F(lr0) * frac)


def log_uniform(gen: torch.Generator, lo: float = 1e-4, hi: float = 1e-2,
                shape=()) -> torch.Tensor:
    """exp(U(log lo, log hi)), drawn from ``gen`` on its device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


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
