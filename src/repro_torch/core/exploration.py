"""Per-worker exploration policies (paper §4.1, §5.1), as
``repro/core/exploration.py``.

The value-based methods use epsilon-greedy where each worker's *final*
epsilon is sampled from {0.1, 0.01, 0.5} with probabilities {0.4, 0.3,
0.3}, annealed from 1.0 over the first ``anneal_frames`` frames.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng

EPS_FINALS = (0.1, 0.01, 0.5)
EPS_PROBS = (0.4, 0.3, 0.3)


def sample_eps_final(key: torch.Tensor, n_workers: int) -> torch.Tensor:
    """(n_workers,) f32 final epsilons, on the key's device."""
    p = torch.tensor(EPS_PROBS, dtype=torch.float32, device=key.device)
    idx = prng.choice(key, 3, (n_workers,), p=p)
    return torch.tensor(EPS_FINALS, dtype=torch.float32,
                        device=key.device)[idx]


def eps_at(eps_final: torch.Tensor, frame: int,
           anneal_frames: int = 100_000) -> torch.Tensor:
    """1 + frac * (eps_final - 1), frac = clip(frame / anneal_frames, 0, 1)
    in f32; ``frame`` is a host int."""
    frac = np.clip(np.float32(frame) / np.float32(anneal_frames),
                   np.float32(0.0), np.float32(1.0))
    return 1.0 + float(frac) * (eps_final - 1.0)


def eps_greedy(keys: torch.Tensor, q_values: torch.Tensor,
               eps) -> torch.Tensor:
    """One key (K, 2) and one row of q_values (K, A) per worker -> actions
    (K,): each key splits into a random action's key and the explore
    draw's.  Under ``prng.margins`` records each greedy choice's top-2
    gap of q and each explore draw's distance from eps."""
    k = prng.split(keys)
    greedy = torch.argmax(q_values, dim=-1)
    rand = prng.randint(k[:, 0], (), 0, q_values.shape[-1])
    u = prng.uniform(k[:, 1], ())
    explore = u < eps
    if prng.logging_margins():
        gap = torch.topk(q_values, 2, dim=-1).values
        gap = torch.where(explore, torch.inf, gap[..., 0] - gap[..., 1])
        prng.record_margin(torch.minimum(gap, (u - eps).abs()))
    return torch.where(explore, rand, greedy)
