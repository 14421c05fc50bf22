"""Beyond the paper: experience replay inside the asynchronous framework
(its Conclusions' proposal), as ``repro/core/replay_async.py``.

Each actor-learner keeps a local ring buffer; each update adds to the
fresh segment's loss (Alg. 1/2) ``replay_weight`` times a one-step Q loss
on a uniform minibatch of the worker's past transitions, once the buffer
holds ``warmup`` of them.  The updates are Hogwild with Shared RMSProp,
as in ``async_runner``.  Every worker pushes t_max transitions a round,
so the buffers' pointer and fill level are one host int for all.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import exploration, prng
from repro_torch.core.agents import Algorithm
from repro_torch.core.async_runner import (clip_per_worker, clone_tree,
                                           worker_grads)
from repro_torch.core.dqn_replay import q_target_loss
from repro_torch.core.rollout import init_worker, rollout_segment
from repro_torch.envs.api import Env
from repro_torch.models.model import flatten, tree_map
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules


@dataclasses.dataclass(frozen=True)
class ReplayAsyncConfig:
    n_workers: int = 8
    t_max: int = 5
    lr0: float = 1e-2
    buffer_size: int = 512          # per worker
    replay_batch: int = 16
    replay_weight: float = 0.5
    warmup: int = 64                # transitions before replay kicks in
    gamma: float = 0.99
    target_interval: int = 2_000
    anneal_frames: int = 20_000
    total_frames: int = 10**9
    max_grad_norm: float = 40.0


def make_replay_runner(algo: Algorithm, env: Env, net_params,
                       cfg: ReplayAsyncConfig):
    """Hogwild runner with per-worker replay buffers mixed into updates:
    (init_state, round_fn) as ``async_runner.make_runner``."""
    opt = opt_mod.shared_rmsprop()
    dev = next(iter(flatten(net_params).values())).device

    def init_state(key):
        k = prng.split(key.to(dev), 3)
        workers = init_worker(env, prng.split(k[0], cfg.n_workers))
        shape = (cfg.n_workers, cfg.buffer_size)
        buf = {"obs": torch.zeros(shape + env.obs_shape, device=dev),
               "next_obs": torch.zeros(shape + env.obs_shape, device=dev),
               "actions": torch.zeros(shape, dtype=torch.int64, device=dev),
               "rewards": torch.zeros(shape, device=dev),
               "dones": torch.zeros(shape, dtype=torch.bool, device=dev)}
        params = clone_tree(net_params)
        return {"params": params, "target_params": clone_tree(params),
                "opt_state": opt.init(params), "workers": workers,
                "buffer": buf, "ptr": 0, "filled": 0,
                "eps_final": exploration.sample_eps_final(k[1],
                                                          cfg.n_workers),
                "frames": 0, "last_target_sync": 0, "rng": k[2]}

    def round_fn(state):
        k = prng.split(state["rng"])
        seg_keys = prng.split(k[1], cfg.n_workers)
        frames = state["frames"]
        lr = schedules.linear_anneal(cfg.lr0, frames, float(cfg.total_frames))
        params, target = state["params"], state["target_params"]
        eps = exploration.eps_at(state["eps_final"], frames,
                                 cfg.anneal_frames)
        with torch.no_grad():
            workers, traj = rollout_segment(
                lambda obs, ns, keys: algo.act(params, obs, ns, keys, eps),
                env, state["workers"], cfg.t_max)

        # append the segment's transitions to each worker's ring buffer
        buf, t = state["buffer"], cfg.t_max
        slots = (state["ptr"] + torch.arange(t, device=dev)) \
            % cfg.buffer_size
        w = torch.arange(cfg.n_workers, device=dev)[:, None]
        for name, v in (("obs", traj["obs"][:, :t]),
                        ("next_obs", traj["obs"][:, 1:]),
                        ("actions", traj["actions"]),
                        ("rewards", traj["rewards"]),
                        ("dones", traj["dones"])):
            buf[name][w, slots] = v
        filled = min(state["filled"] + t, cfg.buffer_size)

        idx = prng.randint(seg_keys, (cfg.replay_batch,), 0, max(filled, 1))
        mb = {name: v[w, idx] for name, v in buf.items()}
        use_replay = float(filled >= cfg.warmup) * cfg.replay_weight

        def loss_fn(p, inp):
            tr, mb_w = inp
            on_loss, metrics = algo.segment_loss(p, target, tr)
            rp_loss = q_target_loss(p, target, mb_w, cfg.gamma)
            return on_loss + use_replay * rp_loss, metrics

        grads, metrics = worker_grads(loss_fn, params, (traj, mb))
        _, rows, _ = clip_per_worker(grads, cfg.max_grad_norm)
        metrics = dict(metrics, ep_ret=workers["last_ep_ret"])
        for g_w in rows:
            opt_mod.update_and_apply(opt, params, g_w, state["opt_state"],
                                     lr)

        frames += cfg.n_workers * t
        last = state["last_target_sync"]
        if frames - last >= cfg.target_interval:
            last = frames
            tree_map(lambda a, b: a.copy_(b), target, params)
        return dict(state, workers=workers, buffer=buf,
                    ptr=state["ptr"] + t, filled=filled, frames=frames,
                    rng=k[0], last_target_sync=last), \
            {name: v.mean() for name, v in metrics.items()}

    return init_state, round_fn
