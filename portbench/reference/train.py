"""The learner's reference: the A3C token loss (the paper's Alg. 3 on the
token-level MDP), its gradients by autograd, and Shared RMSProp (Eq. 8-9),
in float32.

Loss of a batch (tokens, rewards, discounts), B rows of S positions: the
action of position t is token t + 1; the return of t is the longest
forward n-step return r_t + d_t R_{t+1}, bootstrapped from the last
position's value (no gradient); the advantage is R - V (no gradient);
the last position has no action and is left out of every mean:
  loss = -mean(log pi(a) A) + 0.5 mean((R - V)^2) - beta mean(H(pi))
         + aux_weight * (load-balance losses summed over the layers).
RMSProp: g <- alpha g + (1 - alpha) grad^2; p <- p - lr grad / sqrt(g + eps),
lr = lr0 (1 - step / total) computed in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import model as ref_model


def n_step_returns(rewards, discounts, bootstrap):
    out = torch.empty_like(rewards)
    carry = bootstrap
    for t in range(rewards.shape[1] - 1, -1, -1):
        carry = rewards[:, t] + discounts[:, t] * carry
        out[:, t] = carry
    return out


def loss(model: dict, f: dict, batch: dict, *, beta: float = 0.01,
         value_coef: float = 0.5, aux_weight: float = 0.01, lowp=None,
         remat: bool = True):
    out = ref_model.forward(model, f, batch["tokens"], lowp=lowp,
                            remat=remat)
    logits, values = out["logits"], out["value"]
    actions = torch.roll(batch["tokens"], -1, dims=1)
    rets = n_step_returns(batch["rewards"], batch["discounts"],
                          values[:, -1].detach())
    valid = torch.ones_like(batch["rewards"])
    valid[:, -1] = 0.0
    n = valid.sum()
    adv = (rets - values).detach()
    logp = torch.log_softmax(logits, dim=-1)
    logp_a = torch.gather(logp, -1, actions[..., None])[..., 0]
    entropy = -(logp.exp() * logp).sum(-1)
    total = (-(logp_a * adv * valid).sum() / n
             + value_coef * ((rets - values) ** 2 * valid).sum() / n
             - beta * (entropy * valid).sum() / n
             + aux_weight * out["aux"])
    return total


def lr_at(lr0: float, step: int, total: float) -> float:
    f32 = np.float32
    frac = np.clip(f32(1.0) - f32(step) / f32(total), f32(0.0), f32(1.0))
    return float(f32(lr0) * frac)


def follow(model: dict, f: dict, batches, opt: dict, *, lowp=None,
           remat: bool = True, after_step=None) -> dict:
    """Steps of the learner from the parameters ``f`` (float32, updated in
    place) on ``batches`` (a list): {"losses": [...], "grad_norms": {path:
    L2 norm of the first step's gradient}}; ``after_step(step, f)`` is
    called after each update.  A single step keeps no RMSProp
    state: from zeros it is (1 - alpha) grad^2."""
    alpha, eps = opt["alpha"], opt["eps"]
    g_state = {k: torch.zeros_like(v) for k, v in f.items()} \
        if len(batches) > 1 else None
    paths = list(f)
    losses, first = [], None
    for step, b in enumerate(batches):
        leaves = [f[p].requires_grad_(True) for p in paths]
        total = loss(model, f, b, lowp=lowp, remat=remat)
        grads = list(torch.autograd.grad(total, leaves))
        losses.append(float(total.detach()))
        lr = lr_at(opt["lr0"], step, opt["total_steps"])
        with torch.no_grad():
            if first is None:
                first = {p: float(gr.double().norm())
                         for p, gr in zip(paths, grads)}
            for p, gr in zip(paths, grads):
                if g_state is None:
                    g = gr.square().mul_(1.0 - alpha)
                else:
                    g = g_state[p]
                    g.mul_(alpha).addcmul_(gr, gr, value=1.0 - alpha)
                f[p].requires_grad_(False)
                f[p].sub_(lr * gr / torch.sqrt(g + eps))
        del grads, total
        if after_step is not None:
            after_step(step, f)
    return {"losses": losses, "grad_norms": first}
