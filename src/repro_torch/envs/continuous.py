"""Continuous-control proxies for the MuJoCo experiments (paper §5.2.3),
as ``repro/envs/continuous.py``, batched.

PointMass2D drives a point mass to a random target with 2-D force
actions; Pendulum is the torque-limited swing-up (1-D action).  f32
physical states are the observations.  The distance is sqrt(sum(x^2))
(``jnp.linalg.norm``'s arithmetic; ``torch.linalg.norm`` rescales), and
the pendulum's angle wraps by floor-mod as jnp's ``%``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.envs.api import Env, auto_reset


class PMState(NamedTuple):
    pos: torch.Tensor      # (K, 2)
    vel: torch.Tensor      # (K, 2)
    target: torch.Tensor   # (K, 2)
    t: torch.Tensor        # (K,)


def make_pointmass(episode_len: int = 100, dt: float = 0.05) -> Env:

    def reset(keys):
        k = prng.split(keys)
        pos = prng.uniform(k[:, 0], (2,), -1.0, 1.0)
        s = PMState(pos, torch.zeros_like(pos),
                    prng.uniform(k[:, 1], (2,), -1.0, 1.0),
                    torch.zeros(keys.shape[0], dtype=torch.int64,
                                device=keys.device))
        return s, _obs(s)

    def _obs(s: PMState):
        return torch.cat([s.pos, s.vel, s.target], dim=-1)

    def step(s: PMState, action, keys):
        del keys
        force = torch.clamp(action, -1, 1)
        vel = 0.95 * s.vel + dt * force
        pos = torch.clamp(s.pos + dt * vel * 10.0, -1.5, 1.5)
        dist = torch.sqrt(torch.sum(torch.square(pos - s.target), dim=-1))
        reward = -dist + torch.where(dist < 0.1, 1.0, 0.0)
        t = s.t + 1
        done = t >= episode_len
        s2 = PMState(pos, vel, s.target, t)
        return s2, _obs(s2), reward, done

    return Env(name="pointmass2d", reset=reset, step=auto_reset(reset, step),
               obs_shape=(6,), n_actions=2, continuous=True,
               max_episode_len=episode_len)


class PendState(NamedTuple):
    theta: torch.Tensor    # (K,)
    omega: torch.Tensor    # (K,)
    t: torch.Tensor        # (K,)


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp's ``%`` on floats: the truncated remainder, moved by y where its
    sign differs from y's."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def make_pendulum(episode_len: int = 200, dt: float = 0.05) -> Env:
    g, m, l, max_torque, max_speed = 10.0, 1.0, 1.0, 2.0, 8.0

    def reset(keys):
        k = prng.split(keys)
        s = PendState(prng.uniform(k[:, 0], (), -math.pi, math.pi),
                      prng.uniform(k[:, 1], (), -1.0, 1.0),
                      torch.zeros(keys.shape[0], dtype=torch.int64,
                                  device=keys.device))
        return s, _obs(s)

    def _obs(s: PendState):
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta),
                            s.omega / max_speed], dim=-1)

    def step(s: PendState, action, keys):
        del keys
        u = torch.clamp(action[:, 0] * max_torque, -max_torque, max_torque)
        th = _floor_mod(s.theta + math.pi, 2 * math.pi) - math.pi
        cost = th ** 2 + 0.1 * s.omega ** 2 + 0.001 * u ** 2
        omega = s.omega + (3 * g / (2 * l) * torch.sin(th)
                           + 3.0 / (m * l ** 2) * u) * dt
        omega = torch.clamp(omega, -max_speed, max_speed)
        theta = s.theta + omega * dt
        t = s.t + 1
        done = t >= episode_len
        s2 = PendState(theta, omega, t)
        return s2, _obs(s2), -cost, done

    return Env(name="pendulum", reset=reset, step=auto_reset(reset, step),
               obs_shape=(3,), n_actions=1, continuous=True,
               max_episode_len=episode_len)
