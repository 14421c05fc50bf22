"""Tier T3: bounded-staleness delayed synchronisation, as
``repro/core/delayed_sync.py``, on one process.

G replica groups each apply their own updates for H steps, then the
parameters (and, in Shared RMSProp's spirit, the second-moment
accumulators) are averaged: staleness is at most H steps.  The JAX
package stacks the groups on a leading axis for a ``vmap`` (a ``pod``
mesh axis at scale); here they are a list, one parameter tree and one
optimizer state a group, updated by a Python loop over the groups.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.llm_a3c import a3c_token_loss
from repro_torch.models.model import flatten, tree_map
from repro_torch.optim import optimizers as opt_mod


def replicate(tree, n_groups: int) -> List:
    return [tree_map(lambda a: a.detach().clone(), tree)
            for _ in range(n_groups)]


def merge(trees: List):
    """psi-average across the groups."""
    return tree_map(lambda *leaves: torch.stack(leaves).mean(0), *trees)


def merge_every(step: int, h: int, trees: List) -> List:
    """Every group set to the groups' average where ``step`` % h == 0, in
    place; unchanged otherwise."""
    if step % h == 0:
        with torch.no_grad():
            merged = merge(trees)
            for t in trees:
                tree_map(lambda a, b: a.copy_(b), t, merged)
    return trees


def make_delayed_train_step(cfg, opt, *, n_groups: int, merge_interval: int,
                            gamma: float = 0.99, beta: float = 0.01,
                            lr: float = 7e-4,
                            merge_opt_state: bool = True):
    """Grouped train step: ``train_step(params_g, opt_state_g, batch_g,
    step)`` with one parameter tree, optimizer state and batch a group;
    each group updates on its own batch (in place), and the groups merge
    after every ``merge_interval``-th step.  ``merge_opt_state`` shares
    the RMSProp statistics at the merges (the robust variant, Fig. 8);
    False keeps them local (per-thread RMSProp)."""

    def local_update(params, opt_state, batch):
        leaves = list(flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, metrics = a3c_token_loss(cfg, params, batch, gamma=gamma,
                                       beta=beta)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        opt_state = opt_mod.update_and_apply(opt, params, grads, opt_state,
                                             lr)
        return params, opt_state, metrics

    def train_step(params_g, opt_state_g, batch_g, step: int):
        if len(params_g) != n_groups:
            raise ValueError(f"{len(params_g)} parameter trees for "
                             f"{n_groups} groups")
        out = [local_update(p, o, b)
               for p, o, b in zip(params_g, opt_state_g, batch_g)]
        params_g = merge_every(step + 1, merge_interval,
                               [o[0] for o in out])
        opt_state_g = [o[1] for o in out]
        if merge_opt_state:
            opt_state_g = merge_every(step + 1, merge_interval, opt_state_g)
        metrics = {k: torch.stack([o[2][k].detach() for o in out]).mean()
                   for k in out[0][2]}
        return params_g, opt_state_g, metrics

    return train_step
