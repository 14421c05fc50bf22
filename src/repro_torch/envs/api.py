"""Functional environment interface, as ``repro/envs/api.py``, batched.

An env is a pair of functions over a leading worker axis (the JAX
package's ``vmap`` written out), with explicit ``core/prng`` keys:

  reset(keys (K, 2))                   -> (state, obs (K, *obs_shape))
  step(state, action (K, ...), keys)   -> (state, obs, reward (K,), done (K,))

State is a NamedTuple of tensors whose first axis is the worker; every
tensor lives on the keys' device.  ``done`` auto-resets inside ``step``:
the returned state and observation are the fresh episode's, so workers
never synchronise on episode boundaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class Env:
    name: str
    reset: Callable  # (keys) -> (state, obs)
    step: Callable   # (state, action, keys) -> (state, obs, reward, done)
    obs_shape: Tuple[int, ...]
    n_actions: int           # discrete count, or action dim if continuous
    continuous: bool = False
    max_episode_len: int = 1000


def flatten_obs(env: Env) -> Env:
    """Flatten image observations to a vector (for the MLP trunk)."""
    flat = math.prod(env.obs_shape)

    def reset(keys):
        s, o = env.reset(keys)
        return s, o.reshape(o.shape[0], flat)

    def step(state, action, keys):
        s, o, r, d = env.step(state, action, keys)
        return s, o.reshape(o.shape[0], flat), r, d

    return dataclasses.replace(env, reset=reset, step=step,
                               obs_shape=(flat,))


def where_done(done: torch.Tensor, fresh, old):
    """Per worker, ``fresh`` where ``done`` else ``old`` (tensors or
    NamedTuples of tensors with a leading worker axis)."""
    if isinstance(old, tuple):
        return type(old)(*(where_done(done, f, o)
                           for f, o in zip(fresh, old)))
    return torch.where(done.reshape(-1, *(1,) * (old.dim() - 1)), fresh, old)


def auto_reset(reset_fn, step_fn):
    """Wrap a (reset, step) pair so ``done`` restarts the episode.  Each
    worker's key splits into (step, reset) keys.  The JAX package computes
    the fresh episode on every step and selects it where ``done``; here it
    is computed (for every worker, from the same reset keys) only on steps
    where some worker is done, which costs one host sync a step and saves
    the reset's draws on all others."""

    def step(state, action, keys):
        k = prng.split(keys)
        next_state, obs, reward, done = step_fn(state, action, k[:, 0])
        if not bool(done.any()):
            return next_state, obs, reward, done
        fresh_state, fresh_obs = reset_fn(k[:, 1])
        return (where_done(done, fresh_state, next_state),
                where_done(done, fresh_obs, obs), reward, done)

    return step
