"""Rollout collection: one t_max-step segment for every actor-learner at
once (paper Alg. 2/3 inner loop), as ``repro/core/rollout.py`` with its
``vmap`` over workers written out as a leading worker axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core import prng
from repro_torch.envs.api import Env


def init_worker(env: Env, keys: torch.Tensor,
                net_state0=None) -> Dict[str, Any]:
    """K workers from keys (K, 2): each key splits into the env's and the
    worker's stream.  ``net_state0`` (h, c) each (1, L) is copied to every
    worker."""
    k = prng.split(keys)
    env_state, obs = env.reset(k[:, 0])
    n = keys.shape[0]
    zeros = torch.zeros(n, device=keys.device)
    w = {"env_state": env_state, "obs": obs, "rng": k[:, 1],
         "frame": torch.zeros(n, dtype=torch.int64, device=keys.device),
         "ep_ret": zeros, "last_ep_ret": zeros}
    if net_state0 is not None:
        w["net_state"] = tuple(s.to(keys.device).expand(n, *s.shape).clone()
                               for s in net_state0)
    return w


def rollout_segment(act_fn: Callable, env: Env, worker: Dict[str, Any],
                    t_max: int):
    """act_fn(obs, net_state, keys) -> (action, net_state), all batched.

    Returns (new_worker, traj): traj["obs"] (K, T+1, ...) with the
    bootstrap state, "actions", "rewards", "dones" (K, T, ...) and
    traj["net_state"] the segment-start LSTM state.  Each step splits
    every worker's key into (next, act, env) keys; a recurrent worker's
    state is zeroed where its episode ended."""
    has_net_state = "net_state" in worker
    c = dict(worker)
    obs_seq, actions, rewards, dones = [], [], [], []
    for _ in range(t_max):
        k = prng.split(c["rng"], 3)
        action, net_state = act_fn(c["obs"], c.get("net_state"), k[:, 1])
        env_state, obs, reward, done = env.step(c["env_state"], action,
                                                k[:, 2])
        ep_ret = c["ep_ret"] + reward
        obs_seq.append(c["obs"])
        actions.append(action)
        rewards.append(reward)
        dones.append(done)
        c = dict(c, env_state=env_state, obs=obs, rng=k[:, 0],
                 frame=c["frame"] + 1,
                 ep_ret=torch.where(done, 0.0, ep_ret),
                 last_ep_ret=torch.where(done, ep_ret, c["last_ep_ret"]))
        if has_net_state:
            c["net_state"] = tuple(
                torch.where(done[:, None, None], 0.0, s) for s in net_state)
    traj = {"obs": torch.stack(obs_seq + [c["obs"]], dim=1),
            "actions": torch.stack(actions, dim=1),
            "rewards": torch.stack(rewards, dim=1),
            "dones": torch.stack(dones, dim=1)}
    if has_net_state:
        traj["net_state"] = worker["net_state"]
    return c, traj
