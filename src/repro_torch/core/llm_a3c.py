"""A3C at LLM scale, as ``repro/core/llm_a3c.py``: the paper's Alg. 3 loss
on the token-level MDP and its train step (the learner), and per-slot
sampling, the one-token serve step, the fused speculative verify step and
the chunked-prefill step (the actors' serving side).

The learner: state s_t = token prefix, action a_t = tokens[t+1], policy =
the LM head's softmax, critic = the value head.  Every position gets the
longest forward-view n-step return over the sequence axis, bootstrapped
from the last position's value.

Sampling keys.  As in the JAX package, row j's token is
``categorical(fold_in(fold_in(key, sid), pos), logits)`` under a threaded
key, drawn by ``repro_torch.core.prng`` (jax.random's threefry in torch),
so on one seed the port samples the reference's tokens.  A draw depends
only on (key, stream id, absolute position), never on the row's slot, the
batch size or the step count.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import spans
from repro_torch.core import prng
from repro_torch.core.returns import n_step_returns
from repro_torch.distributed import collectives, ctx, fsdp, sharding
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import optimizers as opt_mod
from repro_torch.optim import schedules

def a3c_token_loss(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                   *, gamma: float = 0.99, beta: float = 0.01,
                   value_coef: float = 0.5,
                   layout: Optional[fsdp.Layout] = None):
    """batch: tokens (B, S) [or embeds; an encoder-decoder's also carries
    enc_frames (B, F, d_model), which ``forward`` encodes], rewards
    (B, S), discounts (B, S) = gamma * (1 - done).  Position t's reward is for the transition
    prefix[:t] --tokens[t+1]--> prefix[:t+1].  Returns (loss, metrics), the
    metrics as 0-d tensors (no host sync).  ``gamma`` is carried by the
    discounts; it is in the signature for parity with the JAX package.
    ``layout``: ``params`` are this rank's shards (``M.forward``); under
    tensor parallelism with the vocab split the logits are this rank's
    columns (``logp_entropy``)."""
    out = M.forward(cfg, params, batch, layout)
    logits = out["logits"].float()                    # (B, S, V)
    values = out["value"]                             # (B, S)
    if "actions" in batch:
        actions = batch["actions"]
    else:
        actions = torch.roll(batch["tokens"], -1, dims=1)
    rewards, discounts = batch["rewards"], batch["discounts"]

    # returns over the sequence axis (time-major for the recursion)
    bootstrap = values[:, -1].detach()
    with spans.span("learner.returns"):
        rets = n_step_returns(rewards.T, discounts.T, bootstrap).T  # (B, S)

    valid = torch.ones_like(rewards)
    valid[:, -1] = 0.0                                # last pos: no action
    nvalid = torch.clamp(valid.sum(), min=1.0)
    adv = (rets - values).detach()

    group = None
    if "vocab_start" in out:
        group = sharding.axes_group(layout.mesh, ("model",))
    logp_a, entropy = logp_entropy(logits, actions,
                                   start=out.get("vocab_start", 0),
                                   group=group)

    pol_loss = -(logp_a * adv * valid).sum() / nvalid
    v_loss = value_coef * ((rets - values) ** 2 * valid).sum() / nvalid
    ent_loss = -beta * (entropy * valid).sum() / nvalid
    aux = cfg.aux_loss_weight * out["aux_loss"]
    loss = pol_loss + v_loss + ent_loss + aux
    metrics = {"loss": loss, "pol": pol_loss, "value": v_loss,
               "entropy": -ent_loss / max(beta, 1e-9), "aux": aux,
               "mean_return": (rets * valid).sum() / nvalid}
    return loss, {k: v.detach() for k, v in metrics.items()}


def logp_entropy(logits: torch.Tensor, actions: torch.Tensor, *,
                 start: int = 0, group=None):
    """(log pi(a), entropy), each (B, S), from f32 logits (B, S, V'): the
    log-sum-exp as the max of the logits (no gradient: the loss does not
    depend on it) plus the log of the sum of exp of the shifted logits,
    log pi(a) as the action's shifted logit less it, the entropy as it
    less the softmax mean of the shifted logits -- the reference's
    ``log_softmax`` forms (``repro/core/llm_a3c.py``), summed in this
    order.  Under tensor parallelism with the vocab split (``group``, the
    model group) the logits are this rank's columns [start, start + V'):
    the max goes over the group, the action's logit comes from the rank
    that owns its column, and the three sums take one
    ``collectives.sum_over`` (all-reduce, identity backward: what follows
    it is the same on every rank, so each rank's cotangent of a sum is its
    partial's).  One form for both, so that a split over one rank computes
    the unsharded step's values bit for bit."""
    m = logits.detach().amax(-1)
    if group is not None:
        m = collectives.max_over(m, group)
    z = logits - m[..., None]
    e = torch.exp(z)
    local = actions.long() - start
    own = (local >= 0) & (local < logits.shape[-1])
    idx = local.clamp(0, logits.shape[-1] - 1)[..., None]
    za = torch.gather(z, -1, idx)[..., 0]
    za = torch.where(own, za, torch.zeros_like(za))
    sums = torch.stack([e.sum(-1), (e * z).sum(-1), za])
    if group is not None:
        sums = collectives.sum_over(sums, group)
    se, sez, za = sums.unbind()
    log_z = torch.log(se)
    return za - log_z, log_z - sez / se


def loss_grads(cfg: ModelConfig, params, batch, *, gamma: float = 0.99,
               beta: float = 0.01, layout: Optional[fsdp.Layout] = None,
               data_axes=None):
    """(gradient tree, metrics) of the A3C token loss at ``params`` (f32
    masters, or this rank's shards under ``layout``), turning on
    ``requires_grad`` for every leaf.

    Under an installed mesh (``ctx.use_mesh``) ``batch`` holds this rank's
    rows and the loss is their mean; ranks of the data axes (``data_axes``,
    by default ``sharding.data_axes(mesh)``) hold equal shares, so the
    mean over them is the global loss, and the gradients and metrics are
    averaged over them: a leaf held whole by an all-reduce, a leaf sharded
    over them (FSDP) by dividing the sum its gather's backward
    reduce-scattered.  The model axis computes one loss, every rank of it
    the same: under tensor parallelism the model layer sums over the model
    group the gradients of the whole leaves that each rank uses on its own
    sequence rows or heads (norm scales, the value head, the router,
    whole kv weights: ``collectives.sum_grads``), and a leaf split over the
    model axis has its shard's whole gradient on its rank; nothing more is
    summed over it here."""
    with spans.span("learner.loss"):
        leaves = list(M.flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = a3c_token_loss(cfg, params, batch, gamma=gamma,
                                       beta=beta, layout=layout)
    with spans.span("learner.grad"):
        grads = list(torch.autograd.grad(loss, leaves))
        mesh = ctx.current_mesh()
        if mesh is not None:
            axes = sharding.data_axes(mesh) if data_axes is None \
                else data_axes
            group = sharding.axes_group(mesh, axes)
            n = sharding.axes_size(mesh, axes)
            for path, g in zip(M.flatten(params), grads):
                if layout is None or not any(layout.sharded(path, a)
                                             for a in axes):
                    collectives.all_reduce(g, group)
                g.div_(n)
            vals = collectives.all_reduce(
                torch.stack(list(metrics.values())), group) / n
            metrics = dict(zip(metrics, vals.unbind()))
    paths = iter(grads)
    return M.tree_map(lambda _: next(paths), params), metrics


def make_train_step(cfg: ModelConfig, opt, *, gamma: float = 0.99,
                    beta: float = 0.01, lr0: float = 7e-4,
                    total_steps: int = 100_000,
                    layout: Optional[fsdp.Layout] = None):
    """Synchronous train step, the A2C limit of A3C:
    ``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``step`` is a host int; lr = linear_anneal(lr0, step,
    total_steps) is a host float.

    Unlike the JAX step (immutable arrays), this one updates in place: the
    f32 parameter leaves, and the optimizer state where the optimizer
    writes it (the RMSProp accumulator), are the same tensors before and
    after the call.  ``params`` must be f32 masters on one device; the step
    turns on ``requires_grad`` for every leaf.

    Under an installed mesh the step is data-parallel (``loss_grads``):
    ``batch`` is this rank's rows (``TokenPipeline(mesh=...)``), and with
    ``layout`` the parameters and optimizer state are this rank's shards
    (``fsdp.shard``), which the optimizer updates as its leaves (one
    kernel-8 launch an update, as on one device), tensor- and
    sequence-parallel where the layout splits the model axis
    (``fsdp.layout``); without it every rank holds them whole, as the JAX
    launcher leaves them."""

    def train_step(params, opt_state, batch, step):
        with spans.span("learner.step"):
            lr = schedules.linear_anneal(lr0, step, float(total_steps))
            grads, metrics = loss_grads(cfg, params, batch, gamma=gamma,
                                        beta=beta, layout=layout)
            with spans.span("learner.update"):
                opt_state = opt_mod.update_and_apply(opt, params, grads,
                                                     opt_state, lr)
        return params, opt_state, metrics

    return train_step


def stream_keys(key: torch.Tensor, sids, pos, b: int) -> torch.Tensor:
    """One key a row, from (stream id, logical position): (B, 2), on the
    key's device."""
    dev = key.device
    sids = torch.as_tensor(sids, device=dev).to(torch.int64).expand(b)
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(b)
    return prng.fold_in(prng.fold_in(key, sids), pos)


def sample_slot_tokens(logits: torch.Tensor, key: torch.Tensor, *,
                       sample: bool = True,
                       sids: Optional[torch.Tensor] = None,
                       pos: Optional[torch.Tensor] = None,
                       row0: int = 0) -> torch.Tensor:
    """Per-slot sampling: logits (B, V) and one threaded key (2,) ->
    tokens (B,) int64.

    With ``sids``/``pos`` (the serve engine's path) row j draws from the
    ``fold_in(fold_in(key, sids[j]), pos[j])`` stream, pos being the
    logical position of the sampled token.  Without them row j draws from
    ``fold_in(key, row0 + j)`` and the caller folds its step index into
    ``key``.
    The row keys are hashed where ``sids`` lives (the engine's are host
    data: two hashes of B counters are a few hundred tiny operations,
    far cheaper on the host than as launches on the card), then the noise
    where the logits live."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    b = logits.shape[0]
    if sids is None:
        keys = prng.fold_in(key.to(logits.device),
                            torch.arange(row0, row0 + b,
                                         device=logits.device))
    else:
        sids = torch.as_tensor(sids)
        keys = stream_keys(key.to(sids.device), sids, pos, b)
    return prng.categorical(keys.to(logits.device), logits)


def make_serve_step(cfg: ModelConfig, *, sample: bool = True,
                    layout=None):
    """One-token decode step for the serving path.

    ``serve_step(params, cache, batch, pos, key, sids=None, finite=None)
    -> (token (B,), value (B,), cache)``; ``pos`` a lockstep scalar or per
    slot (B,), moved to the batch's device for the model; ``key`` a
    threaded ``prng`` key.  With ``sids`` the token at logical position
    pos + 1 draws from the (sid, pos + 1) stream of ``key``; host ``sids``
    and ``pos`` keep that hash on the host (``sample_slot_tokens``).
    ``finite``, a bool tensor, is and-ed in place with "every logit of
    this step is finite" (no host sync).  The batch is {"tokens": (B, 1)}
    or a VLM's {"embeds": (B, 1, d), "positions": (3, B, 1)}.

    ``layout``: the serving layout (``fsdp.serve_layout``), run under the
    installed mesh (``ctx.use_mesh``) and ``decode_rules``, ``params``
    this rank's shards and the batch, pos and caches this rank's rows.
    The logits come back whole on every model rank, so every rank of a
    model group draws the same tokens.  Under an installed mesh whose
    ``decode_rules`` split the batch, row j of this rank draws without
    ``sids`` as row j + r * B of the whole batch, r this rank's index over
    the rule's batch axes (the reference's ``fold_in(key, row)``)."""

    kw = {} if layout is None else {"layout": layout}

    def serve_step(params, cache, batch, pos, key, sids=None, finite=None):
        dev = next(iter(batch.values())).device
        with spans.span("serve.model"):
            out, cache = M.decode_step(cfg, params, cache, batch,
                                       pos.to(dev), **kw)
        logits = out["logits"][:, -1].float()
        if finite is not None:
            finite.logical_and_(torch.isfinite(logits).all())
        with spans.span("serve.sample"):
            if sids is None:
                token = sample_slot_tokens(logits, key, sample=sample,
                                           row0=_row0(logits.shape[0]))
            else:
                token = sample_slot_tokens(logits, key, sample=sample,
                                           sids=sids, pos=pos + 1)
        value = out["value"][:, -1] if "value" in out else \
            torch.zeros(logits.shape[0], device=logits.device)
        return token, value, cache

    def _row0(b: int) -> int:
        rule = (ctx.current_rules() or {}).get("decode_cp")
        mesh = ctx.current_mesh()
        if rule is None or mesh is None or not rule["dp_axes"]:
            return 0
        return sharding.axes_rank(mesh, tuple(rule["dp_axes"])) * b

    return serve_step


def make_verify_step(cfg: ModelConfig, shift: int, *, sample: bool = True):
    """The fused speculative round of the serve engine (JAX
    ``llm_a3c.py::make_verify_step``): score a (B, K) batch of draft chunks
    (row j's current token and drafts at positions pos[j] + i), decide
    acceptance and commit exactly the accepted rows' KV, with no host sync.

    ``verify_step(params, cache, batch, pos, key, sids, k_eff, remaining,
    finite=None) -> (targets (B, K), n_acc (B,), cache)``; ``pos``, ``sids``,
    ``k_eff`` and ``remaining`` host tensors (B,).  ``targets[j, i]`` is
    the token the model emits after position pos[j] + i: the argmax, or
    the draw of the (sid, pos + i + 1) stream, the one ``make_serve_step``
    draws that token from, so accepted sampled tokens are those of plain
    decode bit for bit.  The accept rule: the leading run of drafts that
    match the targets within row j's effective k, plus the target after
    it, clamped to ``remaining[j]`` (0 marks an idle row, which commits
    nothing).  ``shift``: the engine's logical cache length.  ``finite``,
    a bool tensor, is and-ed in place with "every logit is finite"."""

    def verify_step(params, cache, batch, pos, key, sids, k_eff, remaining,
                    finite=None):
        dev = batch["tokens"].device
        out, pendings = M.verify_step(cfg, params, cache, batch,
                                      pos.to(dev), shift)
        logits = out["logits"].float()                  # (B, K, V)
        b, kq, v = logits.shape
        if finite is not None:
            finite.logical_and_(torch.isfinite(logits).all())
        if not sample:
            targets = torch.argmax(logits, dim=-1)
        else:
            # the row keys hashed on the host, where sids and pos are
            tpos = pos[:, None].to(torch.int64) + 1 + torch.arange(kq)
            skeys = prng.fold_in(key.to(sids.device),
                                 torch.as_tensor(sids).to(torch.int64))
            keys = prng.fold_in(skeys[:, None, :], tpos)     # (B, K, 2)
            targets = prng.categorical(keys.reshape(b * kq, 2).to(dev),
                                       logits.reshape(b * kq, v))
            targets = targets.reshape(b, kq)
        match = batch["tokens"][:, 1:] == targets[:, :-1]    # (B, K-1)
        in_k = torch.arange(kq - 1, device=dev)[None, :] < \
            (k_eff.to(dev)[:, None] - 1)
        run = torch.cumprod((match & in_k).to(torch.int32), dim=1)
        n_acc = torch.minimum(run.sum(dim=1) + 1, remaining.to(dev))
        cache = M.commit_step(cfg, cache, pendings, pos.to(dev), n_acc)
        return targets, n_acc, cache

    return verify_step


def make_prefill_step(cfg: ModelConfig):
    """Chunked prefill for the serve engine:
    ``prefill_step(params, cache, batch, pos0=0, true_len=None) ->
    (logits (B, C, V) in the compute dtype, cache)``: the engine takes the
    rows it needs and widens those to f32 (the whole block in f32 would
    be B C V x 4 bytes).  None when the architecture's caches
    cannot be block-written (recurrent states, zamba2's shared block, the
    encoder-decoder): the engine then admits through its token loop."""
    if not M.supports_chunked_prefill(cfg):
        return None

    def prefill_step(params, cache, batch, pos0=0, true_len=None):
        with spans.span("serve.model"):
            out, cache = M.prefill_step(cfg, params, cache, batch, pos0,
                                        true_len)
        return out["logits"], cache

    return prefill_step
