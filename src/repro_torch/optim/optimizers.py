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

Both RMSProp flavours route every leaf through ``dispatch.rmsprop_update``
(the kernel on the card, the plain version on the CPU); the JAX package's
``fused`` switch has no counterpart: its unfused path (lr * grad /
sqrt(g + eps)) and its Pallas path (lr * grad * rsqrt(g + eps)) differ by
f32 rounding only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.model import tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]  # (grads, state, lr) -> ...


def shared_rmsprop(*, alpha: float = 0.99, eps: float = 0.1) -> Optimizer:
    def init(params):
        return {"g": tree_map(torch.zeros_like, params)}

    def update(grads, state, lr):
        out = tree_map(lambda g, dg: dispatch.rmsprop_update(
            g, dg, lr=lr, alpha=alpha, eps=eps), state["g"], grads)
        new_g = tree_map(lambda g, o: o[0], state["g"], out)
        updates = tree_map(lambda g, o: o[1], state["g"], out)
        return updates, {"g": new_g}

    return Optimizer("shared_rmsprop", init, update)


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

    return Optimizer("momentum_sgd", init, update)


def apply_updates(params: Params, updates: Params) -> Params:
    """params -= updates, leaf by leaf, in place (outside autograd, so the
    leaves may require grad); returns params."""
    with torch.no_grad():
        tree_map(lambda p, u: p.sub_(u.to(p.dtype)), params, updates)
    return params


OPTIMIZERS = {
    "shared_rmsprop": shared_rmsprop,
    "rmsprop": rmsprop,
    "momentum_sgd": momentum_sgd,
}
