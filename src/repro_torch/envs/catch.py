"""Catch, the minimal Atari proxy, as ``repro/envs/catch.py``, batched.

A ball falls from a random column; the agent moves a paddle (left, stay,
right) along the bottom row.  +1 for catching, -1 for missing; an episode
lasts ``rows`` - 1 steps.  Integer state (int64), f32 pixel observations
(K, rows, cols, 1) equal to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.envs.api import Env, auto_reset


class CatchState(NamedTuple):
    ball: torch.Tensor     # (K, 2) row, col
    paddle: torch.Tensor   # (K,) col
    t: torch.Tensor        # (K,)


def make(rows: int = 10, cols: int = 5) -> Env:

    def reset(keys):
        col = prng.randint(keys, (), 0, cols)
        zero = torch.zeros_like(col)
        s = CatchState(torch.stack([zero, col], dim=-1),
                       torch.full_like(col, cols // 2), zero)
        return s, _obs(s)

    def _obs(s: CatchState):
        k = s.ball.shape[0]
        w = torch.arange(k, device=s.ball.device)
        g = torch.zeros((k, rows, cols), dtype=torch.float32,
                        device=s.ball.device)
        g[w, s.ball[:, 0], s.ball[:, 1]] = 1.0
        g[w, rows - 1, s.paddle] = 1.0
        return g[..., None]

    def step(s: CatchState, action, keys):
        del keys
        paddle = torch.clamp(s.paddle + action - 1, 0, cols - 1)
        ball = torch.stack([s.ball[:, 0] + 1, s.ball[:, 1]], dim=-1)
        done = ball[:, 0] >= rows - 1
        caught = done & (ball[:, 1] == paddle)
        reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
        s2 = CatchState(ball, paddle, s.t + 1)
        return s2, _obs(s2), reward, done

    return Env(name=f"catch{rows}x{cols}", reset=reset,
               step=auto_reset(reset, step), obs_shape=(rows, cols, 1),
               n_actions=3, max_episode_len=rows)
