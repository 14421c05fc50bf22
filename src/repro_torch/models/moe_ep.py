"""Expert-parallel MoE over the model group, as ``repro/models/moe_ep.py``.

Each rank of the model axis routes its own slice of the tokens and owns
E / tp of the experts:

  route the local tokens -> the (E, C, d) send buffer
  all-to-all over the model group: each expert's slots to its owner
  the local experts' gated MLP on (E / tp, tp * C, d)
  all-to-all back -> combine with the gates

Tokens: the caller's rows are this rank's share of the batch over the data
axes (``dp_axes``; the train step has split it already).  Under sequence
parallelism (``sp``) they are already the model rank's slice of the
sequence, the Megatron-SP residual's rows, and the block routes them as
they are.  Otherwise they are the whole sequence, held alike on every
model rank: the block takes the rank's slice of the sequence
(``x_spec``'s P(dp, 'model', None)) and all-gathers the outputs back into
the whole sequence.  The capacity is the reference's
expert-parallel expression over the local tokens, without the dense
path's cap at the token count.  The load-balance loss is averaged over
the model and data groups.

Expert weights come as this rank's E / tp experts (the FSDP layout holds
them so, ``distributed/fsdp.py``).  The router is held whole; each model
rank's gradient of it covers its own tokens, so the backward sums them.

The exchange: ``dist.all_to_all_single`` sends chunk k of the (E, C, d)
buffer (rank k's experts) to rank k and receives (tp * E / tp, C, d) in
source-rank order, which is permuted into (E / tp, tp * C, d), slot
source-major, as the reference's ``all_to_all(split_axis=0,
concat_axis=1, tiled=True)``; the return is the reverse, and each
exchange's backward is the same exchange of the cotangent.  The expert
products are ``torch.bmm``, as in ``moe.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import collectives, sharding
from repro_torch.models import moe


def _local_route(router, xf, *, top_k: int, n_experts: int, cap: int):
    """Route T_loc tokens; the (E, cap, d) send buffer and what the
    combine needs."""
    gates, eidx, lb_loss = moe.gate(router, xf, top_k)
    e_flat = eidx.reshape(-1)
    pos = moe.slot_positions(e_flat, n_experts)
    keep = pos < cap
    send = moe.dispatch(xf, e_flat, pos, keep, n_experts, cap, top_k)
    route = {"e_flat": e_flat, "pos": pos, "keep": keep, "gates": gates}
    return send, route, lb_loss


def _local_combine(out_buf, route, top_k: int):
    return moe.combine(out_buf, route["e_flat"], route["pos"],
                       route["keep"], route["gates"], top_k)


def capacity(b: int, s: int, tp: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds on each rank, for ``b`` rows of this rank's
    data share and a sequence of ``s`` over ``tp`` model ranks."""
    t_loc = b * (s // tp)
    return int(max(top_k, capacity_factor * t_loc * top_k / n_experts))


def moe_apply_ep(p: dict, x: torch.Tensor, *, top_k: int,
                 capacity_factor: float, act: str, rule: dict,
                 sp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B_loc, S, d), this rank's rows -> (y (B_loc, S, d), the
    load-balance loss averaged over the ranks); with ``sp`` x and y are
    this model rank's S / tp rows of the sequence.  ``rule``: the
    ``moe_ep`` entry of ``sharding.activation_rules`` (mesh, tp, dp_axes).
    S and E must divide by tp; the expert weights are this rank's E / tp."""
    mesh, tp = rule["mesh"], int(rule["tp"])
    b, s, d = x.shape
    if sp:
        s *= tp
    e = p["router"].shape[1]
    if e % tp or s % tp:
        raise ValueError(f"experts {e} and sequence {s} must divide over "
                         f"the {tp} model ranks")
    e_loc = e // tp
    group = sharding.axes_group(mesh, ("model",))
    cap = capacity(b, s, tp, top_k, e, capacity_factor)

    ws = [p[k] for k in ("w_gate", "w_up", "w_down")]
    if ws[0].shape[0] != e_loc:
        raise ValueError(f"the expert weights hold {ws[0].shape[0]} experts; "
                         f"each of the {tp} model ranks takes its {e_loc} "
                         "(hold them by fsdp.layout)")
    router = collectives.sum_grads(p["router"], group)
    xl = x if sp else collectives.scatter_slice(x, group, 1)  # (b, s/tp, d)
    xf = xl.reshape(b * (s // tp), d)

    send, route, lb = _local_route(router, xf, top_k=top_k, n_experts=e,
                                   cap=cap)
    # experts to their owners: (E, C, d) -> (E_loc, tp * C, d)
    recv = collectives.all_to_all(send, group)
    recv = recv.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)
    out = moe.experts(recv, *ws, act)
    back = out.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(
        e, cap, d)
    back = collectives.all_to_all(back, group)
    y = _local_combine(back, route, top_k).reshape(b, s // tp, d)

    axes = tuple(rule["dp_axes"]) + ("model",)
    lb = collectives.mean_over(lb, sharding.axes_group(mesh, axes),
                               copies=tp)
    return (y if sp else collectives.gather_slice(y, group, 1)), lb
