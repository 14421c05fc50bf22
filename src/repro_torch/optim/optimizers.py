"""The paper's three optimizers (§4.5), as ``repro/optim/optimizers.py``.

  * shared_rmsprop — non-centred RMSProp whose second-moment accumulator g
    is SHARED across actor-learners (Eq. 8-9).
  * rmsprop        — identical math; the runner keeps one g per worker.
  * momentum_sgd   — per-worker momentum m = alpha * m + (1 - alpha) * grad.

API: ``opt.init(params) -> state``; ``opt.update(grads, state, lr) ->
(updates, state)``; ``apply_updates(params, updates)`` subtracts the
updates.  ``lr`` is a host float.  Unlike the JAX package, state and
parameters are updated in place: the RMSProp accumulator is written by
the update kernel over itself, and ``apply_updates`` subtracts into the
parameter leaves, so a full-size learner holds one copy of each.
``update_and_apply(opt, params, grads, state, lr)`` does both, in one
pass where the optimizer can (``opt.apply``), and is what the runners and
train steps call.  Over a mesh the parameters may be this rank's shards
(``distributed/fsdp.py``): ``init`` then gives the state the same layout
(the reference's ``opt_state_shardings``: g mirrors the parameters), and
the update runs on the shards as its leaves.

Both RMSProp flavours send all leaves of an update to one kernel launch
(``dispatch.rmsprop_update_multi``; with ``update_and_apply``,
``dispatch.rmsprop_apply_multi``, which also subtracts: the kernel on the
card, the plain version leaf by leaf on the CPU, the same bits as
``update`` + ``apply_updates``); the JAX package's ``fused`` switch has no
counterpart: its unfused path (lr * grad / sqrt(g + eps)) and its Pallas
path (lr * grad * rsqrt(g + eps)) differ by f32 rounding only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.model import flatten, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]  # (grads, state, lr) -> ...
    # (params, grads, state, lr) -> state: the update subtracted from the
    # parameters, in place
    apply: Callable[..., Any]


def leaves(tree) -> list:
    """The leaves of a tree, in ``tree_map`` order."""
    return list(flatten(tree).values())


def shared_rmsprop(*, alpha: float = 0.99, eps: float = 0.1) -> Optimizer:
    def init(params):
        return {"g": tree_map(torch.zeros_like, params)}

    def update(grads, state, lr):
        upds = iter(dispatch.rmsprop_update_multi(
            leaves(state["g"]), leaves(grads), lr=lr, alpha=alpha, eps=eps))
        return tree_map(lambda _: next(upds), grads), state

    def apply(params, grads, state, lr):
        with torch.no_grad():
            dispatch.rmsprop_apply_multi(
                leaves(params), leaves(state["g"]), leaves(grads), lr=lr,
                alpha=alpha, eps=eps)
        return state

    return Optimizer("shared_rmsprop", init, update, apply)


def rmsprop(**kw) -> Optimizer:
    """Per-worker RMSProp: the same math; whether g is shared or per worker
    is decided by the runner, which keeps one state or one per worker."""
    return dataclasses.replace(shared_rmsprop(**kw), name="rmsprop")


def momentum_sgd(*, alpha: float = 0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(grads, state, lr):
        new_m = tree_map(lambda m, dg: m.mul_(alpha).add_((1 - alpha) * dg),
                         state["m"], grads)
        return tree_map(lambda m: lr * m, new_m), {"m": new_m}

    def apply(params, grads, state, lr):
        updates, state = update(grads, state, lr)
        apply_updates(params, updates)
        return state

    return Optimizer("momentum_sgd", init, update, apply)


def apply_updates(params: Params, updates: Params) -> Params:
    """params -= updates, leaf by leaf, in place (outside autograd, so the
    leaves may require grad); returns params."""
    with torch.no_grad():
        tree_map(lambda p, u: p.sub_(u.to(p.dtype)), params, updates)
    return params


def update_and_apply(opt: Optimizer, params: Params, grads: Params, state,
                     lr: float):
    """``opt.update`` then ``apply_updates``, with the same bits: RMSProp in
    one pass (one kernel launch for up to 64 leaves, the subtraction
    fused), ``momentum_sgd`` as the two calls.  Parameters and state
    change in place.  Returns the new state."""
    return opt.apply(params, grads, state, lr)


OPTIMIZERS = {
    "shared_rmsprop": shared_rmsprop,
    "rmsprop": rmsprop,
    "momentum_sgd": momentum_sgd,
}
