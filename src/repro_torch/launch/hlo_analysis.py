"""Roofline terms and the kernels a step dispatched, as the half of
``repro/launch/hlo_analysis.py`` that has a counterpart here.

``roofline_terms`` is the reference's arithmetic: seconds a step for the
compute, memory and collective terms, and the largest of them.
``kernel_dispatch_summary`` reports which hand-written kernels and model
routes a run took since the last ``dispatch.reset_launch_counts()``: the
port's launch and route counters, where the reference reports its
dispatch's decision log for a lowering.

The reference's HLO parser (``split_computations``, ``weighted_totals``,
``collective_bytes``) has no counterpart: it walks the partitioned HLO
text of a compiled XLA program, trip-count-weighting While bodies, to
recover dot FLOPs and the collectives GSPMD placed.  Eager PyTorch builds
no such program, and the port places its collectives itself
(``distributed/collectives.py`` counts each one it issues), so the
planner takes its compute term from the model's FLOPs and reports no
collective bytes for a step it does not run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict, List


def roofline_terms(*, hlo_flops: float, hbm_bytes: float,
                   collective_total: float, n_chips: int,
                   peak_flops: float, hbm_bw: float, ici_bw: float
                   ) -> Dict[str, float]:
    """Seconds a step for each roofline term: ``hlo_flops`` (whole program)
    over the chips' peak rate, ``hbm_bytes`` (a chip's traffic,
    ``traffic.hbm_bytes``) over its memory rate, ``collective_total`` (a
    chip's collective bytes) over its link rate; ``dominant`` names the
    largest."""
    t_compute = hlo_flops / (n_chips * peak_flops)
    t_memory = hbm_bytes / hbm_bw
    t_coll = collective_total / ici_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "dominant": dominant}


def kernel_dispatch_summary() -> List[dict]:
    """The kernels and routes taken since the last reset:
    [{"op": name, "kind": "launch" | "route", "count": n}, ...], the ones
    taken at least once."""
    from repro_torch.kernels import dispatch
    out = [{"op": op, "kind": "launch", "count": n}
           for op, n in dispatch.launch_counts().items() if n]
    out += [{"op": op, "kind": "route", "count": n}
            for op, n in dispatch.route_counts().items() if n]
    return out
