"""A3C at LLM scale, as ``repro/core/llm_a3c.py``: the paper's Alg. 3 loss
on the token-level MDP and its train step (the learner), and per-slot
sampling, the one-token serve step and the chunked-prefill step (the
actors' serving side).

The learner: state s_t = token prefix, action a_t = tokens[t+1], policy =
the LM head's softmax, critic = the value head.  Every position gets the
longest forward-view n-step return over the sequence axis, bootstrapped
from the last position's value.

Sampling keys.  The JAX package draws row j's token from the threefry
stream ``fold_in(fold_in(key, sid), pos)``, which torch cannot reproduce,
so cross-framework parity is greedy only.  The port keeps the invariant
that matters: each draw depends only on (seed, stream id, absolute
position), never on the row's slot, the batch size or the step count.  It
samples by Gumbel-max, with the noise of vocabulary entry v taken from a
counter hash of (seed, sid, pos, v) computed in integer torch ops.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.returns import n_step_returns
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

_M32 = 0xFFFFFFFF


def a3c_token_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   *, gamma: float = 0.99, beta: float = 0.01,
                   value_coef: float = 0.5):
    """batch: tokens (B, S) [or embeds], rewards (B, S), discounts (B, S) =
    gamma * (1 - done).  Position t's reward is for the transition
    prefix[:t] --tokens[t+1]--> prefix[:t+1].  Returns (loss, metrics), the
    metrics as 0-d tensors (no host sync).  ``gamma`` is carried by the
    discounts; it is in the signature for parity with the JAX package."""
    out = M.forward(cfg, params, batch)
    logits = out["logits"].float()                    # (B, S, V)
    values = out["value"]                             # (B, S)
    if "actions" in batch:
        actions = batch["actions"]
    else:
        actions = torch.roll(batch["tokens"], -1, dims=1)
    rewards, discounts = batch["rewards"], batch["discounts"]

    # returns over the sequence axis (time-major for the recursion)
    bootstrap = values[:, -1].detach()
    rets = n_step_returns(rewards.T, discounts.T, bootstrap).T   # (B, S)

    valid = torch.ones_like(rewards)
    valid[:, -1] = 0.0                                # last pos: no action
    nvalid = torch.clamp(valid.sum(), min=1.0)
    adv = (rets - values).detach()

    logp_all = torch.log_softmax(logits, dim=-1)
    logp_a = torch.gather(logp_all, -1, actions[..., None].long())[..., 0]
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1)

    pol_loss = -(logp_a * adv * valid).sum() / nvalid
    v_loss = value_coef * ((rets - values) ** 2 * valid).sum() / nvalid
    ent_loss = -beta * (entropy * valid).sum() / nvalid
    aux = cfg.aux_loss_weight * out["aux_loss"]
    loss = pol_loss + v_loss + ent_loss + aux
    metrics = {"loss": loss, "pol": pol_loss, "value": v_loss,
               "entropy": -ent_loss / max(beta, 1e-9), "aux": aux,
               "mean_return": (rets * valid).sum() / nvalid}
    return loss, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt, *, gamma: float = 0.99,
                    beta: float = 0.01, lr0: float = 7e-4,
                    total_steps: int = 100_000):
    """Synchronous train step, the A2C limit of A3C:
    ``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``step`` is a host int; lr = linear_anneal(lr0, step,
    total_steps) is a host float.

    Unlike the JAX step (immutable arrays), this one updates in place: the
    f32 parameter leaves, and the optimizer state where the optimizer
    writes it (the RMSProp accumulator), are the same tensors before and
    after the call.  ``params`` must be f32 masters on one device; the step
    turns on ``requires_grad`` for every leaf."""

    def train_step(params, opt_state, batch, step):
        lr = schedules.linear_anneal(lr0, step, float(total_steps))
        leaves = list(M.flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = a3c_token_loss(cfg, params, batch, gamma=gamma,
                                       beta=beta)
        grads = torch.autograd.grad(loss, leaves)
        paths = iter(grads)
        grads = M.tree_map(lambda _: next(paths), params)
        updates, opt_state = opt.update(grads, opt_state, lr)
        params = opt_mod.apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2^32.
    The multipliers are odd and below 2^31, so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, sids: torch.Tensor, pos: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) f32 Gumbel(0, 1) noise; row j depends only on
    (seed, sids[j], pos[j])."""
    dev = sids.device
    h = _mix(torch.full_like(sids, int(seed) & _M32))
    h = _mix(h ^ (sids & _M32))
    h = _mix(h ^ (pos & _M32))                                     # (B,)
    v = torch.arange(vocab, device=dev, dtype=torch.int64)
    u = _mix(h[:, None] ^ ((v * 0x61C88647) & _M32)[None, :])      # (B, V)
    # 24 high bits -> uniform in (0, 1), never 0 or 1 in f32
    unif = ((u >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(unif))


def sample_slot_tokens(logits: torch.Tensor, seed: int = 0, *,
                       sample: bool = True,
                       sids: Optional[torch.Tensor] = None,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling: logits (B, V) -> tokens (B,) int64.

    With ``sids``/``pos`` (the serve engine's path) row j draws from the
    (seed, sids[j], pos[j]) stream, pos being the logical position of the
    sampled token.  Without them row j uses stream id j at position 0 and
    the caller folds its step index into ``seed``."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    b, vocab = logits.shape
    dev = logits.device
    if sids is None:
        sids = torch.arange(b, device=dev)
        pos = torch.zeros(b, dtype=torch.int64, device=dev)
    sids = torch.as_tensor(sids, device=dev).to(torch.int64).expand(b)
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(b)
    noise = gumbel_noise(seed, sids, pos, vocab)
    return torch.argmax(logits.float() + noise, dim=-1)


def make_serve_step(cfg: ModelConfig, *, sample: bool = True):
    """One-token decode step for the serving path.

    ``serve_step(params, cache, batch, pos, seed, sids=None, finite=None)
    -> (token (B,), value (B,), cache)``; ``pos`` a lockstep scalar or per
    slot (B,).  With ``sids`` the token at logical position pos + 1 draws
    from the (seed, sid, pos + 1) stream.  ``finite``, a bool tensor, is
    and-ed in place with "every logit of this step is finite" (no host
    sync)."""

    def serve_step(params, cache, batch, pos, seed, sids=None, finite=None):
        out, cache = M.decode_step(cfg, params, cache, batch, pos)
        logits = out["logits"][:, -1].float()
        if finite is not None:
            finite.logical_and_(torch.isfinite(logits).all())
        if sids is None:
            token = sample_slot_tokens(logits, seed, sample=sample)
        else:
            token = sample_slot_tokens(logits, seed, sample=sample,
                                       sids=sids, pos=pos + 1)
        value = out["value"][:, -1] if "value" in out else \
            torch.zeros(logits.shape[0], device=logits.device)
        return token, value, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Chunked prefill for the serve engine:
    ``prefill_step(params, cache, batch, pos0=0, true_len=None) ->
    (logits (B, C, V) f32, cache)``.  None when the architecture's caches
    cannot be block-written."""
    if not M.supports_chunked_prefill(cfg):
        return None

    def prefill_step(params, cache, batch, pos0=0, true_len=None):
        out, cache = M.prefill_step(cfg, params, cache, batch, pos0,
                                    true_len)
        return out["logits"].float(), cache

    return prefill_step
