"""DQN with experience replay, the paper's comparison baseline (§3.2), as
``repro/core/dqn_replay.py``.

A uniform replay buffer and a target network (Mnih et al. 2015) on one
environment stream: the "parallel actors replace replay" ablation.  Every
frame splits the key into (next, act, env, sample) keys, as the
reference does; the minibatch draw and the update run only on frames
that train (every ``train_every`` frames once ``warmup`` frames are in),
where the reference computes both and selects.  Frames, the buffer
pointer and the swap test live on the host.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.func import grad

from repro_torch.core import exploration, prng
from repro_torch.core.async_runner import clone_tree
from repro_torch.envs.api import Env
from repro_torch.models import atari as nets
from repro_torch.models.model import flatten, tree_map
from repro_torch.optim import optimizers as opt_mod


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    buffer_size: int = 10_000
    batch_size: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    target_interval: int = 1_000
    train_every: int = 4
    warmup: int = 500
    eps_final: float = 0.05
    anneal_frames: int = 20_000


def q_target_loss(params, target_params, batch, gamma):
    """Mean squared one-step Q error of transitions (obs, actions,
    rewards, dones, next_obs), the target network without gradient."""
    feats, _ = nets.trunk(params, batch["obs"], None)
    q = nets.q_heads(params, feats)
    feats_t, _ = nets.trunk(target_params, batch["next_obs"], None)
    q_t = nets.q_heads(target_params, feats_t).detach()
    not_done = 1.0 - batch["dones"].float()
    y = batch["rewards"] + gamma * not_done * torch.amax(q_t, -1)
    qa = torch.gather(q, -1, batch["actions"][:, None].long())[:, 0]
    return torch.mean((y - qa) ** 2)


def make_dqn(env: Env, params, cfg: DQNConfig):
    """Returns (init_state, step_fn); step_fn(state) -> state advances one
    frame, updating the state's tensors in place.  The environment runs
    as a batch of one."""
    opt = opt_mod.shared_rmsprop()
    dev = next(iter(flatten(params).values())).device

    def init_state(key):
        k = prng.split(key.to(dev))
        env_state, obs = env.reset(k[0][None])
        n = cfg.buffer_size
        buf = {"obs": torch.zeros((n,) + env.obs_shape, device=dev),
               "next_obs": torch.zeros((n,) + env.obs_shape, device=dev),
               "actions": torch.zeros(n, dtype=torch.int64, device=dev),
               "rewards": torch.zeros(n, device=dev),
               "dones": torch.zeros(n, dtype=torch.bool, device=dev)}
        p = clone_tree(params)
        return {"params": p, "target_params": clone_tree(p),
                "opt_state": opt.init(p), "buffer": buf, "ptr": 0,
                "filled": 0, "env_state": env_state, "obs": obs,
                "frames": 0, "rng": k[1],
                "ep_ret": torch.zeros(1, device=dev),
                "last_ep_ret": torch.zeros(1, device=dev)}

    def step_fn(state):
        k = prng.split(state["rng"], 4)
        eps = exploration.eps_at(torch.tensor([cfg.eps_final], device=dev),
                                 state["frames"], cfg.anneal_frames)
        p = state["params"]
        with torch.no_grad():
            feats, _ = nets.trunk(p, state["obs"], None)
            action = exploration.eps_greedy(k[1][None],
                                            nets.q_heads(p, feats), eps)
            env_state, obs, reward, done = env.step(state["env_state"],
                                                    action, k[2][None])
        slot = state["ptr"] % cfg.buffer_size
        buf = state["buffer"]
        for name, v in (("obs", state["obs"]), ("next_obs", obs),
                        ("actions", action), ("rewards", reward),
                        ("dones", done)):
            buf[name][slot] = v[0]
        filled = min(state["filled"] + 1, cfg.buffer_size)
        frames = state["frames"] + 1
        if frames % cfg.train_every == 0 and frames >= cfg.warmup:
            idx = prng.randint(k[3], (cfg.batch_size,), 0, filled)
            mb = {name: v[idx] for name, v in buf.items()}
            g = grad(q_target_loss)(p, state["target_params"], mb,
                                    cfg.gamma)
            opt_mod.update_and_apply(opt, p, g, state["opt_state"], cfg.lr)
        if frames % cfg.target_interval == 0:
            tree_map(lambda t, s: t.copy_(s), state["target_params"], p)
        ep_ret = state["ep_ret"] + reward
        return dict(state, ptr=state["ptr"] + 1, filled=filled,
                    env_state=env_state, obs=obs, frames=frames, rng=k[0],
                    ep_ret=torch.where(done, 0.0, ep_ret),
                    last_ep_ret=torch.where(done, ep_ret,
                                            state["last_ep_ret"]))

    return init_state, step_fn
