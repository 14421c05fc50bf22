"""Tier T3: bounded-staleness delayed synchronisation, as
``repro/core/delayed_sync.py`` and the delayed mode of
``repro/launch/dryrun.py``.

G replica groups each apply their own updates for H steps, then the
parameters (and, in Shared RMSProp's spirit, the second-moment
accumulators) are averaged: staleness is at most H steps.  The JAX
package stacks the groups on a leading axis for a ``vmap``, sharded over
the ``pod`` mesh axis at scale.  The port has both forms:

* no mesh: the groups are a list, one parameter tree and one optimizer
  state a group, updated by a Python loop over the groups;
* under a mesh with a ``pod`` axis (``ctx.use_mesh``): each pod index is
  one group, whose ranks hold its parameters and accumulator as shards of
  the inner layout (``fsdp.layout(..., pod_groups=True)``: FSDP over the
  data axis inside the pod) and its batch rows over the data axis; a group
  updates data-parallel inside its pod, and the merge is an all-reduce
  average over the pod group.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.llm_a3c import loss_grads
from repro_torch.distributed import collectives, ctx, sharding
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


def merge_over_pods(step: int, h: int, tree, mesh) -> None:
    """Where ``step`` % h == 0, every leaf of this group's ``tree`` (its
    shards) set to its average over the pod group, in place."""
    if step % h == 0:
        group = sharding.axes_group(mesh, ("pod",))
        n = sharding.axes_size(mesh, ("pod",))
        with torch.no_grad():
            for t in flatten(tree).values():
                collectives.all_reduce(t, group).div_(n)


def make_delayed_train_step(cfg, opt, *, n_groups: int, merge_interval: int,
                            gamma: float = 0.99, beta: float = 0.01,
                            lr: float = 7e-4,
                            merge_opt_state: bool = True, layout=None):
    """Grouped train step: ``train_step(params_g, opt_state_g, batch_g,
    step)``; each group updates on its own batch (in place), and the groups
    merge after every ``merge_interval``-th step.  ``merge_opt_state``
    shares the RMSProp statistics at the merges (the robust variant, Fig.
    8); False keeps them local (per-thread RMSProp).

    Without a mesh, ``params_g``, ``opt_state_g`` and ``batch_g`` hold one
    entry a group.  Under a mesh with a ``pod`` axis of ``n_groups`` ranks
    they are this rank's group's parameters and state (its shards under
    ``layout``) and its rows of the group's batch; the metrics are the
    mean over the groups, as the list form's."""

    def local_update(params, opt_state, batch, data_axes=None):
        grads, metrics = loss_grads(cfg, params, batch, gamma=gamma,
                                    beta=beta, layout=layout,
                                    data_axes=data_axes)
        opt_state = opt_mod.update_and_apply(opt, params, grads, opt_state,
                                             lr)
        return params, opt_state, metrics

    def pod_step(params, opt_state, batch, step: int, mesh):
        params, opt_state, metrics = local_update(params, opt_state, batch,
                                                  ("data",))
        merge_over_pods(step + 1, merge_interval, params, mesh)
        if merge_opt_state:
            merge_over_pods(step + 1, merge_interval, opt_state, mesh)
        group = sharding.axes_group(mesh, ("pod",))
        vals = collectives.all_reduce(torch.stack(list(metrics.values())),
                                      group) / n_groups
        return params, opt_state, dict(zip(metrics, vals.unbind()))

    def train_step(params_g, opt_state_g, batch_g, step: int):
        mesh = ctx.current_mesh()
        if mesh is not None and "pod" in mesh.mesh_dim_names:
            if sharding.axes_size(mesh, ("pod",)) != n_groups:
                raise ValueError(f"{n_groups} groups on a mesh of "
                                 f"{sharding.mesh_shape(mesh)}")
            return pod_step(params_g, opt_state_g, batch_g, step, mesh)
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
