"""Forward-view n-step returns (paper §4.3/4.4) and GAE(lambda), as
``repro/core/returns.py``.

For a rollout segment every state gets the "longest possible n-step
return", the reverse recursion R <- r_i + discount_i * R seeded with the
bootstrap value; ``discounts`` carries gamma * (1 - done) per step, so an
episode boundary inside a segment cuts the recursion.  The JAX package's
reverse ``lax.scan`` becomes a reverse loop over the time axis.
"""
from __future__ import annotations

import torch


def n_step_returns(rewards: torch.Tensor, discounts: torch.Tensor,
                   bootstrap: torch.Tensor) -> torch.Tensor:
    """rewards, discounts (T, ...); bootstrap (...) -> returns (T, ...):
    returns[i] = rewards[i] + discounts[i] * returns[i + 1], returns[T] =
    bootstrap.  Time is axis 0."""
    out = []
    carry = bootstrap
    for i in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[i] + discounts[i] * carry
        out.append(carry)
    return torch.stack(out[::-1])


def n_step_returns_ref(rewards, discounts, bootstrap) -> torch.Tensor:
    """O(T^2) oracle: each return summed afresh from the bootstrap."""
    out = []
    for i in range(rewards.shape[0]):
        acc = bootstrap
        for j in range(rewards.shape[0] - 1, i - 1, -1):
            acc = rewards[j] + discounts[j] * acc
        out.append(acc)
    return torch.stack(out)


def gae_advantages(rewards: torch.Tensor, discounts: torch.Tensor,
                   values: torch.Tensor, bootstrap: torch.Tensor, *,
                   lam: float = 0.95):
    """Generalised advantage estimation (beyond the paper).  values (T, ...)
    V(s_i); bootstrap V(s_T).  Returns (advantages (T, ...), returns =
    advantages + values)."""
    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    deltas = rewards + discounts * next_values - values
    out = []
    carry = torch.zeros_like(bootstrap)
    for i in range(rewards.shape[0] - 1, -1, -1):
        carry = deltas[i] + lam * discounts[i] * carry
        out.append(carry)
    adv = torch.stack(out[::-1])
    return adv, adv + values
