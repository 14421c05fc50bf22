"""Mixture-of-Experts layer: top-k router and capacity-based dispatch, as
``repro/models/moe.py``, and a dropless dispatch (``moe_apply_dropless``).

Tokens are written into a fixed-capacity buffer of E experts x C slots,
the experts run as three batched products over the stacked expert weights
(``torch.bmm``: the JAX package's three ``einsum``s, which it computes
outside any Pallas kernel), and each token's k outputs are read back and
summed with its gates.  The layer also returns the Switch load-balance
loss, E * sum_e f_e * P_e, which the training loss adds times
``aux_loss_weight``.

The semantics are the reference's, so tokens and gradients compare:

  * the router runs in f32 (a bf16 model casts the router matrix to bf16
    with every other matrix; it is cast back up here, as jax promotes it);
  * top-k takes a stable descending sort, so on tied probabilities the
    lower expert index comes first, as ``jax.lax.top_k`` does (a zero
    input row ties every expert);
  * the capacity is the reference's own Python expression;
  * a slot's position is the running count of its expert's assignments
    over the token-major (token, then rank) order: earlier tokens win
    capacity over later ones, whatever their rank;
  * a dropped assignment contributes nothing and reads back nothing (the
    reference writes a zero into slot 0 and reads slot 0 with gate 0).

Differences of arithmetic, not of result: the dispatch writes each kept
row once (kept (expert, slot) pairs are unique; dropped rows go to a
spare slot past the capacity that is never read) where the reference
scatter-adds; and the combine sums each token's k gathered rows over k in
one reduction (accumulated in f32, rounded once) where the reference
scatter-adds them one by one in the compute dtype.  In f32 the two agree
to summation order; in bf16 the port's sum may differ from a sequential
bf16 scatter by up to (k - 1) / 2 bf16 ulps of the summed magnitude.  No
atomics: the results repeat bit for bit.

The dropless layer (Granite-4.0-H's) has no capacity: every assignment
to an expert this model holds is computed.  Its router (``gate_logits``)
takes each token's top k by a stable descending sort of the f32 logits,
as the published router's top-k of logits (a sort of the probabilities
would tie experts whose probabilities underflow), and gates them with the
softmax over the k selected logits; the held assignments are sorted by
expert (a stable
sort, unheld ones last) and the held experts' gated MLPs run as grouped
products over the stacked weights: ``torch._grouped_mm`` on the card,
with the group offsets on the device (no host sync), a loop on the CPU.
Each token's k outputs are gated and summed over k as in ``combine``.  A
token's output depends on that token alone.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import common as cm

ROUTER_STD = 0.02


def moe_shapes(d_model: int, d_ff: int, n_experts: int,
               held: int = 0) -> dict:
    """The router over all ``n_experts``; the stacked weights of the
    ``held`` experts (all where 0)."""
    e = held or n_experts
    return {"router": (d_model, n_experts),
            "w_gate": (e, d_model, d_ff),
            "w_up": (e, d_model, d_ff),
            "w_down": (e, d_ff, d_model)}


# leaf order of ``init_moe``'s split of its key in four
LEAVES = ("router", "w_gate", "w_up", "w_down")


def init_std(name: str, d_model: int, d_ff: int) -> float:
    """Spread of ``init_moe``'s truncated normal for leaf ``name``."""
    if name == "router":
        return ROUTER_STD
    if name in ("w_gate", "w_up"):
        return 1.0 / math.sqrt(d_model)
    if name == "w_down":
        return 1.0 / math.sqrt(d_ff)
    raise ValueError(f"unknown MoE leaf {name}")


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds for ``t`` tokens: the reference's expression
    in Python floats, never more than the tokens."""
    cap = int(max(top_k, capacity_factor * t * top_k / n_experts))
    return min(cap, t)


def slot_positions(e_flat: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's place among its expert's assignments, in the
    order given: the running count the reference takes down a (T*k, E)
    one-hot.  The one-hot is laid out (E, T*k) so the count runs along the
    contiguous axis (down the other axis a GPU scans E long columns with
    little parallelism)."""
    experts = torch.arange(n_experts, device=e_flat.device)[:, None]
    hits = (experts == e_flat[None, :]).to(torch.int32)          # (E, T*k)
    return torch.cumsum(hits, dim=1).gather(0, e_flat[None, :])[0] - 1


def route(probs: torch.Tensor, top_k: int):
    """(gates, expert indices) of the top k probabilities a row, the
    highest first and the lower index first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k]


def gate(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """Route T tokens (T, d): (gates (T, k) normalised over k, expert
    indices (T, k), the Switch load-balance loss () f32), the router in
    f32."""
    e = router.shape[1]
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)       # (T, E)
    gates, eidx = route(probs, top_k)                                # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss on the full probabilities; f_e carries no gradient
    f_e = torch.nn.functional.one_hot(eidx[:, 0], e).float().mean(0)
    return gates, eidx, e * torch.sum(f_e * probs.mean(0))


def gate_logits(router: torch.Tensor, xf: torch.Tensor, top_k: int):
    """The dropless layer's routing of T tokens (T, d): (gates (T, k), the
    softmax over the k largest logits, expert indices (T, k), the Switch
    load-balance loss () f32 as ``gate``'s), the router in f32."""
    e = router.shape[1]
    logits = xf.float() @ router.float()                             # (T, E)
    vals, eidx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, eidx = torch.softmax(vals[:, :top_k], dim=-1), eidx[:, :top_k]
    f_e = torch.nn.functional.one_hot(eidx[:, 0], e).float().mean(0)
    lb = e * torch.sum(f_e * torch.softmax(logits, dim=-1).mean(0))
    return gates, eidx, lb


def dispatch(xf: torch.Tensor, e_flat: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, n_experts: int, cap: int, top_k: int
             ) -> torch.Tensor:
    """The (E, cap, d) expert buffer: each token's row k times,
    token-major (an expand: its gradient sums over k); kept rows land in
    distinct slots, dropped ones in slot ``cap`` of their expert, which is
    cut off."""
    t, d = xf.shape
    rows = xf[:, None, :].expand(t, top_k, d).reshape(t * top_k, d)
    slot = e_flat * (cap + 1) + torch.where(keep, pos, cap)
    return xf.new_zeros((n_experts * (cap + 1), d)).index_put(
        (slot,), rows).reshape(n_experts, cap + 1, d)[:, :cap]


def experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, act: str) -> torch.Tensor:
    """A gated MLP over each expert's slots: (E, C, d) -> (E, C, d)."""
    f = cm.ACTIVATIONS[act]
    return torch.bmm(f(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up),
                     w_down)


def combine(out: torch.Tensor, e_flat: torch.Tensor, pos: torch.Tensor,
            keep: torch.Tensor, gates: torch.Tensor, top_k: int
            ) -> torch.Tensor:
    """Each token's k rows of the (E, C, d) expert outputs, gated (0 where
    dropped), summed over k: (T, d)."""
    e, cap, d = out.shape
    read = e_flat * cap + torch.where(keep, pos, 0)
    g = gates.reshape(-1).to(out.dtype) * keep.to(out.dtype)
    y = out.reshape(e * cap, d)[read] * g[:, None]
    return y.reshape(-1, top_k, d).sum(1)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, load-balance loss () f32)."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    t = b * s
    xf = x.reshape(t, d)
    gates, eidx, lb_loss = gate(p["router"], xf, top_k)
    # capacity-based dispatch, token-major priority
    cap = capacity(t, top_k, e, capacity_factor)
    e_flat = eidx.reshape(-1)                                        # (T*k,)
    pos = slot_positions(e_flat, e)
    keep = pos < cap
    buf = dispatch(xf, e_flat, pos, keep, e, cap, top_k)
    out = experts(buf, p["w_gate"], p["w_up"], p["w_down"], act)
    y = combine(out, e_flat, pos, keep, gates, top_k)
    return y.reshape(b, s, d), lb_loss


def moe_apply_local(p: dict, x: torch.Tensor, *, top_k: int,
                    capacity_factor: float = 1.25, act: str = "silu",
                    first: int = 0) -> torch.Tensor:
    """The dense layer's partial sum over the experts [first, first + E_loc)
    that ``p``'s expert leaves hold (the serving layout's E / tp a model
    rank; the router is whole): every row is routed over all E experts
    under the global capacity and slot order, exactly as ``moe_apply``
    routes it, and only the assignments to these experts are computed.
    Summed over the model ranks, it is ``moe_apply``'s output (a decode
    step is one token a row, which the expert-parallel block cannot split
    over the ranks; the reference runs the dense block there).  x (B, S,
    d) -> (B, S, d) in x's dtype."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    e_loc = p["w_gate"].shape[0]
    t = b * s
    xf = x.reshape(t, d)
    gates, eidx, _ = gate(p["router"], xf, top_k)
    cap = capacity(t, top_k, e, capacity_factor)
    e_flat = eidx.reshape(-1)
    pos = slot_positions(e_flat, e)
    local = e_flat - first
    mine = (local >= 0) & (local < e_loc)
    keep = (pos < cap) & mine
    local = local.clamp(0, e_loc - 1)
    buf = dispatch(xf, local, pos, keep, e_loc, cap, top_k)
    out = experts(buf, p["w_gate"], p["w_up"], p["w_down"], act)
    return combine(out, local, pos, keep, gates, top_k).reshape(b, s, d)


def _grouped(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
             ends) -> torch.Tensor:
    """Rows of ``a`` (M, K) sorted by group, group g's rows ending at
    offs[g], each times w[g] (G, K, N) -> (M, N); the rows past the last
    group are not computed (zeros on the CPU, unspecified on the card).
    ``ends``: the offsets on the host, for the CPU's loop (None on the
    card)."""
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=offs)
    out = a.new_zeros((a.shape[0], w.shape[-1]))
    lo = 0
    for g, hi in enumerate(ends):
        if hi > lo:
            out[lo:hi] = a[lo:hi] @ w[g]
        lo = hi
    return out


def held_experts(p: dict, xf: torch.Tensor, gates: torch.Tensor,
                 eidx: torch.Tensor, act: str, first: int = 0,
                 on_counts=None) -> torch.Tensor:
    """Every assignment of the T tokens ``xf`` (T, d) to an expert held in
    ``p`` (experts [first, first + E_held) of the router's), with no
    capacity: (T, d) in xf's dtype, each token's held outputs gated and
    summed over k.  ``on_counts``, where given, is called with (the held
    assignments a held expert takes (E_held,), the held assignments in
    all) as device tensors."""
    t, d = xf.shape
    k = eidx.shape[1]
    e_held = p["w_gate"].shape[0]
    local = eidx.reshape(-1) - first                              # (T*k,)
    held = (local >= 0) & (local < e_held)
    key = torch.where(held, local, e_held)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=e_held + 1)[:e_held]
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    ends = None if xf.is_cuda else offs.tolist()
    if on_counts is not None:
        on_counts(counts, offs[-1])
    # rows past the held ones are zeroed, so no value (or gradient) of a
    # row the grouped products leave unspecified reaches a token; in place,
    # since a prefill chunk's T k rows are gigabytes
    unheld = ~held[order][:, None]
    rows = xf[order // k].masked_fill_(unheld, 0)
    f = cm.ACTIVATIONS[act]
    h = f(_grouped(rows, p["w_gate"], offs, ends)) * \
        _grouped(rows, p["w_up"], offs, ends)
    out = _grouped(h, p["w_down"], offs, ends).masked_fill_(unheld, 0)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    g = torch.where(held, gates.reshape(-1), 0).to(out.dtype)
    return out[inv].mul_(g[:, None]).reshape(t, k, d).sum(1)


def moe_apply_dropless(p: dict, x: torch.Tensor, *, top_k: int,
                       act: str = "silu", first: int = 0, on_counts=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, load-balance loss () f32):
    the dropless layer over the experts ``p`` holds (``held_experts``),
    routed over all of the router's."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, eidx, lb_loss = gate_logits(p["router"], xf, top_k)
    y = held_experts(p, xf, gates, eidx, act, first, on_counts)
    return y.reshape(b, s, d), lb_loss
