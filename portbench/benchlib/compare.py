"""The numbers that decide ``correct``, each held to its limit.

Training, held: the first step's loss, relative to the reference's; the
first gradient's norm and the parameters' change after the first step,
each by the worst leaf: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.  Leaves whose first gradient in the reference is under a
thousandth of the median leaf's (a gradient that is nought but for
rounding, as a key's bias under softmax) are left out of the change:
Shared RMSProp moves them by round-off alone.  The later steps' losses
and the change after three steps are read too, but not held: at the
learner's rate the steps after the first amplify bfloat16 rounding, the
reference's own in bfloat16 as much as the program's (PERF.md).

Serving: for each served token, how far its logit, plus the Gumbel noise
of its draw, lies below the reference's best (zero noise for a greedy
token): the widest such gap over the sample.
"""
from __future__ import annotations

import statistics

FLAT = 1e-3     # a leaf whose first gradient is under FLAT x the median's


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{path: |n_prog - n_ref| / max(n_ref, the median leaf's n_ref)}."""
    med = statistics.median(ref[p] for p in ref)
    return {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-300)
            for p in ref if keep is None or p in keep}


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def moving_leaves(ref_grads: dict) -> set:
    med = statistics.median(ref_grads.values())
    return {p for p, n in ref_grads.items() if n >= FLAT * med}


def _loss_gaps(prog: dict, ref: dict) -> list:
    return [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]


def train_numbers(prog: dict, ref: dict) -> dict:
    """The numbers held.  prog and ref: {"losses", "grad_norms",
    "change1_norms", "change_norms"}."""
    return {
        "loss1_gap": _loss_gaps(prog, ref)[0],
        "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"]),
        "update1_gap": worst_leaf(prog["change1_norms"],
                                  ref["change1_norms"],
                                  moving_leaves(ref["grad_norms"])),
    }


def train_readings(prog: dict, ref: dict) -> dict:
    """What the calibration prints beside the numbers held: each step's
    loss gap, the change's gap of the median leaf and the worst leaves."""
    keep = moving_leaves(ref["grad_norms"])
    upd = leaf_gaps(prog["change_norms"], ref["change_norms"], keep)
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    gaps = _loss_gaps(prog, ref)
    return dict(
        train_numbers(prog, ref),
        loss_gap=max(gaps), update_gap=max(upd.values(), default=0.0),
        loss_gaps=gaps,
        losses=list(prog["losses"]), ref_losses=list(ref["losses"]),
        update_gap_median=statistics.median(upd.values()),
        worst_update=sorted(upd, key=upd.get)[-3:],
        worst_grad=max(grad, key=grad.get))


def held(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}}: each number at most its limit."""
    out = {}
    for k, v in numbers.items():
        out[k] = {"value": v, "limit": limits.get(k)}
    return out


def passes(checks: dict) -> bool:
    """Every number within its limit (at most it, or at least it where the
    check says ``at_least``); a number that is not a number, or has no
    limit, fails."""
    def ok(c):
        v, lim = c["value"], c["limit"]
        if lim is None or v != v:
            return False
        return v >= lim if c.get("at_least") else v <= lim
    return all(ok(c) for c in checks.values())
