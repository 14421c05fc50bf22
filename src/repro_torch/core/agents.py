"""The four asynchronous algorithms (paper §4.1-4.4) as (act, loss) pairs,
as ``repro/core/agents.py``.

Each algorithm supplies:
  act(params, obs, net_state, keys, eps)          -> (action, net_state)
  segment_loss(params, target_params, traj)       -> (scalar loss, metrics)

``act`` is batched over workers: obs (K, ...), one key (K, 2) and one eps
per worker (or one for all), the LSTM state (h, c) each (K, 1, L) as the
JAX runner's vmap carries it.  ``segment_loss`` takes one worker's
rollout segment (the runners ``torch.func.vmap`` it over workers): obs
(T+1, ...) including the bootstrap state, actions (T,), rewards (T,),
dones (T,) and the LSTM state at the segment start (1, L), from which
the loss re-runs the recurrent trunk straight through the segment, a
``done`` inside it included, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import exploration, prng
from repro_torch.core.returns import gae_advantages, n_step_returns
from repro_torch.models import atari as nets


@dataclasses.dataclass(frozen=True)
class Algorithm:
    name: str
    act: Callable
    segment_loss: Callable
    needs_target: bool
    policy_based: bool


def _forward(params, obs, net_state):
    """obs (K, ...), net_state (h, c) each (K, 1, L) or None."""
    if net_state is None:
        feats, _ = nets.trunk(params, obs, None)
        return feats, None
    k = obs.shape[0]
    h, c = (s.reshape(k, -1) for s in net_state)
    feats, (h, c) = nets.trunk(params, obs, (h, c))
    return feats, (h.reshape(k, 1, -1), c.reshape(k, 1, -1))


def _forward_segment(params, obs_seq, net_state0):
    """Run the trunk over one worker's (T+1, ...) observations, threading
    the LSTM state; feedforward nets take them as one batch."""
    if "lstm" in params:
        st, feats = net_state0, []
        for t in range(obs_seq.shape[0]):
            f, st = nets.trunk(params, obs_seq[t][None], st)
            feats.append(f[0])
        return torch.stack(feats)
    feats, _ = nets.trunk(params, obs_seq, None)
    return feats


def _take(x, idx):
    """x (T, A), idx (T,) -> x[t, idx[t]]."""
    return torch.gather(x, -1, idx[:, None].long())[:, 0]


# ---------------------------------------------------------------------------
# A3C (Alg. 3), discrete and continuous
# ---------------------------------------------------------------------------

def make_a3c(*, gamma: float = 0.99, beta: float = 0.01,
             value_coef: float = 0.5, continuous: bool = False,
             beta_continuous: float = 1e-4,
             gae_lambda: float = 0.0) -> Algorithm:
    """gae_lambda > 0 enables GAE(lambda) advantages; 0 is the paper's
    n-step advantage."""

    def act(params, obs, net_state, keys, eps):
        del eps
        feats, net_state = _forward(params, obs, net_state)
        if continuous:
            h = nets.gaussian_heads(params, feats)
            noise = prng.normal(keys, h["mu"].shape[-1:])
            return h["mu"] + torch.sqrt(h["sigma2"])[:, None] * noise, \
                net_state
        h = nets.actor_critic_heads(params, feats)
        return prng.categorical(keys, h["logits"]), net_state

    def segment_loss(params, target_params, traj, **_):
        del target_params
        feats = _forward_segment(params, traj["obs"], traj.get("net_state"))
        discounts = gamma * (1.0 - traj["dones"].float())
        if continuous:
            h = nets.gaussian_heads(params, feats)
            values = h["value"]
            bootstrap = values[-1].detach()
            rets = n_step_returns(traj["rewards"], discounts, bootstrap)
            adv = (rets - values[:-1]).detach()
            mu, s2 = h["mu"][:-1], h["sigma2"][:-1]
            logp = -0.5 * (torch.sum((traj["actions"] - mu) ** 2, -1) / s2
                           + mu.shape[-1] * torch.log(2 * math.pi * s2))
            entropy = 0.5 * (torch.log(2 * math.pi * s2) + 1.0)
            pol_loss = -torch.mean(logp * adv)
            ent_loss = -beta_continuous * torch.mean(entropy)
        else:
            h = nets.actor_critic_heads(params, feats)
            values = h["value"]
            bootstrap = values[-1].detach()
            if gae_lambda > 0:
                adv, rets = gae_advantages(
                    traj["rewards"], discounts, values[:-1].detach(),
                    bootstrap, lam=gae_lambda)
                adv = adv.detach()
            else:
                rets = n_step_returns(traj["rewards"], discounts, bootstrap)
                adv = (rets - values[:-1]).detach()
            logp_all = torch.log_softmax(h["logits"][:-1], dim=-1)
            logp = _take(logp_all, traj["actions"])
            entropy = -torch.sum(torch.exp(logp_all) * logp_all, -1)
            pol_loss = -torch.mean(logp * adv)
            ent_loss = -beta * torch.mean(entropy)
        v_loss = value_coef * torch.mean((rets - values[:-1]) ** 2)
        loss = pol_loss + v_loss + ent_loss
        metrics = {"loss": loss, "pol": pol_loss, "value": v_loss,
                   "entropy": -ent_loss, "mean_return": torch.mean(rets)}
        return loss, metrics

    return Algorithm("a3c", act, segment_loss, needs_target=False,
                     policy_based=True)


# ---------------------------------------------------------------------------
# value-based: one-step Q (Alg. 1), one-step Sarsa (Eq. 6), n-step Q (Alg. 2)
# ---------------------------------------------------------------------------

def _q_act(params, obs, net_state, keys, eps):
    feats, net_state = _forward(params, obs, net_state)
    q = nets.q_heads(params, feats)
    return exploration.eps_greedy(keys, q, eps), net_state


def _q_pair(params, target_params, traj):
    """Q of the online and (without gradient) the target network along
    the segment, (T+1, A) each."""
    feats = _forward_segment(params, traj["obs"], traj.get("net_state"))
    feats_t = _forward_segment(target_params, traj["obs"],
                               traj.get("net_state"))
    return (nets.q_heads(params, feats),
            nets.q_heads(target_params, feats_t).detach())


def make_one_step_q(*, gamma: float = 0.99) -> Algorithm:

    def segment_loss(params, target_params, traj, **_):
        q, q_t = _q_pair(params, target_params, traj)
        not_done = 1.0 - traj["dones"].float()
        y = traj["rewards"] + gamma * not_done * torch.amax(q_t[1:], -1)
        qa = _take(q[:-1], traj["actions"])
        loss = torch.mean((y - qa) ** 2)
        return loss, {"loss": loss, "q_mean": torch.mean(qa)}

    return Algorithm("one_step_q", _q_act, segment_loss, needs_target=True,
                     policy_based=False)


def make_one_step_sarsa(*, gamma: float = 0.99) -> Algorithm:

    def segment_loss(params, target_params, traj, **_):
        q, q_t = _q_pair(params, target_params, traj)
        not_done = 1.0 - traj["dones"].float()
        # the Sarsa target needs the action taken at s': within a segment
        # that is actions[i + 1], so the last transition is left out
        # (t_max - 1 updates a segment, as the reference)
        q_next_a = _take(q_t[1:-1], traj["actions"][1:])
        y = traj["rewards"][:-1] + gamma * not_done[:-1] * q_next_a
        qa = _take(q[:-2], traj["actions"][:-1])
        loss = torch.mean((y - qa) ** 2)
        return loss, {"loss": loss, "q_mean": torch.mean(qa)}

    return Algorithm("one_step_sarsa", _q_act, segment_loss,
                     needs_target=True, policy_based=False)


def make_n_step_q(*, gamma: float = 0.99) -> Algorithm:

    def segment_loss(params, target_params, traj, **_):
        q, q_t = _q_pair(params, target_params, traj)
        discounts = gamma * (1.0 - traj["dones"].float())
        bootstrap = torch.amax(q_t[-1], -1)
        rets = n_step_returns(traj["rewards"], discounts, bootstrap)
        qa = _take(q[:-1], traj["actions"])
        loss = torch.mean((rets - qa) ** 2)
        return loss, {"loss": loss, "q_mean": torch.mean(qa),
                      "mean_return": torch.mean(rets)}

    return Algorithm("n_step_q", _q_act, segment_loss, needs_target=True,
                     policy_based=False)


ALGORITHMS = {
    "a3c": make_a3c,
    "one_step_q": make_one_step_q,
    "one_step_sarsa": make_one_step_sarsa,
    "n_step_q": make_n_step_q,
}
