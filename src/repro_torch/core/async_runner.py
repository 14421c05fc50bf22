"""Asynchronous actor-learner runner, the paper's core mechanism, as
``repro/core/async_runner.py``.

Tier T1 ("hogwild"): K workers roll out in parallel from the same
parameter snapshot, then their gradients are applied SEQUENTIALLY to the
shared parameters: worker k's gradient lands on parameters that k - 1
other updates have already moved (bounded staleness in [0, K - 1]).

Tier T2 ("sync"): the same rollouts, one averaged update (A2C, the
synchronous limit of A3C).

Shared or per-worker optimizer statistics (paper §4.5, Fig. 8): with
``shared_stats`` one RMSProp accumulator is threaded through the
sequential updates (Shared RMSProp); otherwise each worker owns one.
Target networks of the value-based methods are swapped once
``target_interval`` frames have passed since the last swap.

The port's round is eager PyTorch on one device: all K rollouts step
together along the worker axis, the K gradients come from one
``torch.func.vmap`` of ``torch.func.grad`` over the workers' segments,
all taken from the round's snapshot before the first update, each
clipped by its own norm.  Updates then run in place through the
optimizer (``optimizers.update_and_apply``: on the card, one launch of
the RMSProp kernel a worker update, over every leaf).  ``frames``, the lr
and the swap test stay on the host, and the target network is a copy,
moved only at a swap.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import grad, vmap

from repro_torch.core import exploration, prng
from repro_torch.core.agents import Algorithm
from repro_torch.core.rollout import init_worker, rollout_segment
from repro_torch.envs.api import Env
from repro_torch.models.model import flatten, tree_map, unflatten
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    n_workers: int = 16
    t_max: int = 5
    lr0: float = 7e-4
    total_frames: int = 200_000
    target_interval: int = 2_000
    anneal_frames: int = 50_000
    mode: str = "hogwild"          # hogwild (T1) | sync (T2)
    optimizer: str = "shared_rmsprop"
    shared_stats: bool = True
    max_grad_norm: float = 40.0
    lr_schedule: str = "linear"


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def worker_grads(loss_fn, params, batched) -> tuple:
    """The gradient of ``loss_fn(params, one worker's inputs) -> (loss,
    metrics)`` for every worker, from one vmap over the leading axis of
    ``batched``: (grads (K, ...) per leaf, metrics (K,))."""
    return vmap(grad(loss_fn, has_aux=True), in_dims=(None, 0))(params,
                                                                batched)


def clip_per_worker(grads, max_norm: float):
    """Scale each worker's gradient to a global norm of at most
    ``max_norm``.  Returns (a tree of (K, ...) gradients, one list entry
    a worker of trees, norms (K,)).  Each worker's leaf starts on a
    16-byte boundary, as the update kernel requires: rows of a leaf
    whose size is not a multiple of 4 elements sit in a buffer padded to
    one."""
    flat = flatten(grads)
    k = next(iter(flat.values())).shape[0]
    sq = sum(g.reshape(k, -1).square().sum(1) for g in flat.values())
    gnorm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-8), 1.0)
    stacked, rows = {}, [{} for _ in range(k)]
    for path, g in flat.items():
        n = g[0].numel()
        buf = torch.empty((k, -(-n // 4) * 4), dtype=g.dtype,
                          device=g.device)
        out = buf[:, :n]
        torch.mul(g.reshape(k, n), scale[:, None], out=out)
        stacked[path] = out.view(g.shape)
        for i in range(k):
            rows[i][path] = out[i].view(g.shape[1:])
    return unflatten(stacked), [unflatten(r) for r in rows], gnorm


def make_runner(algo: Algorithm, env: Env, net_params, cfg: RunnerConfig,
                *, net_state0=None):
    """Returns (init_state, round_fn): round_fn(state) advances all workers
    by one t_max segment, applies their updates and returns (state,
    metrics averaged over the workers).  The state's parameters,
    optimizer statistics and target network are updated in place."""
    opt = opt_mod.OPTIMIZERS[cfg.optimizer]()
    sched = schedules.SCHEDULES[cfg.lr_schedule]

    def init_state(key):
        dev = next(iter(flatten(net_params).values())).device
        k = prng.split(key.to(dev), 3)
        workers = init_worker(env, prng.split(k[0], cfg.n_workers),
                              net_state0)
        params = clone_tree(net_params)
        if cfg.shared_stats:
            opt_state: Any = opt.init(params)
        else:
            opt_state = [opt.init(params) for _ in range(cfg.n_workers)]
        return {
            "params": params,
            "target_params": clone_tree(params),
            "opt_state": opt_state,
            "workers": workers,
            "eps_final": exploration.sample_eps_final(k[1], cfg.n_workers),
            "frames": 0,
            "last_target_sync": 0,
            "rng": k[2],
        }

    def round_fn(state):
        params, target = state["params"], state["target_params"]
        frames = state["frames"]
        lr = sched(cfg.lr0, frames, float(cfg.total_frames))
        eps = exploration.eps_at(state["eps_final"], frames,
                                 cfg.anneal_frames)

        with torch.no_grad():
            workers, traj = rollout_segment(
                lambda obs, ns, keys: algo.act(params, obs, ns, keys, eps),
                env, state["workers"], cfg.t_max)

        def loss_fn(p, tr):
            return algo.segment_loss(p, target, tr)

        grads, metrics = worker_grads(loss_fn, params, traj)
        grads, rows, gnorm = clip_per_worker(grads, cfg.max_grad_norm)
        metrics = dict(metrics, grad_norm=gnorm,
                       ep_ret=workers["last_ep_ret"])

        opt_state = state["opt_state"]
        if cfg.mode == "sync":
            g_mean = tree_map(lambda g: g.mean(0), grads)
            ost = opt_state if cfg.shared_stats else opt_state[0]
            ost = opt_mod.update_and_apply(opt, params, g_mean, ost, lr)
            if not cfg.shared_stats:
                for other in opt_state[1:]:
                    tree_map(lambda a, b: a.copy_(b), other, ost)
        elif cfg.mode == "hogwild":
            for i, g_w in enumerate(rows):
                ost = opt_state if cfg.shared_stats else opt_state[i]
                opt_mod.update_and_apply(opt, params, g_w, ost, lr)
        else:
            raise ValueError(cfg.mode)

        frames += cfg.n_workers * cfg.t_max
        last = state["last_target_sync"]
        if frames - last >= cfg.target_interval:
            last = frames
            if algo.needs_target:
                tree_map(lambda t, p: t.copy_(p), target, params)
        new_state = dict(state, workers=workers, frames=frames,
                         last_target_sync=last)
        return new_state, {k: v.mean() for k, v in metrics.items()}

    return init_state, round_fn


@torch.no_grad()
def evaluate(algo: Algorithm, env: Env, params, key, *,
             n_episodes: int = 8, max_steps: int = 1000,
             net_state0=None) -> torch.Tensor:
    """Near-greedy evaluation (eps 0.01): the mean undiscounted return of
    the first episode of each of ``n_episodes`` streams of ``key``."""
    dev = next(iter(flatten(params).values())).device
    k = prng.split(prng.split(key.to(dev), n_episodes))
    env_state, obs = env.reset(k[:, 0])
    k_steps = prng.split(k[:, 1], max_steps)
    ns = None
    if net_state0 is not None:
        ns = tuple(s.to(dev).expand(n_episodes, *s.shape).clone()
                   for s in net_state0)
    ret = torch.zeros(n_episodes, device=dev)
    done_seen = torch.zeros(n_episodes, device=dev)
    eps = torch.tensor(0.01, device=dev)
    for t in range(max_steps):
        kt = prng.split(k_steps[:, t])
        action, ns = algo.act(params, obs, ns, kt[:, 0], eps)
        env_state, obs, reward, done = env.step(env_state, action, kt[:, 1])
        ret = ret + reward * (1.0 - done_seen)
        done_seen = torch.maximum(done_seen, done.float())
    return ret.mean()

