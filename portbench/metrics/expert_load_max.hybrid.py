"""expert_load_max.hybrid: how much busier the busiest held expert is than
the mean of the held experts hit, at a decode step: each ``model.moe``
record inside an ``engine.decode`` record of the traced stretch gives
rows_max / (assignments / experts_hit), and the reading is their mean
(1 where the hit experts share the rows evenly)."""
from benchlib import spans


def read(view):
    if view.trace is None:
        return None
    steps = [(r.start, r.end)
             for r in spans.records(view.trace, "engine.decode")]
    ratios = [r.counts["rows_max"] * r.counts["experts_hit"]
              / r.counts["assignments"]
              for r in spans.records(view.trace, "model.moe")
              if r.counts.get("assignments")
              and any(s <= r.start and r.end <= e for s, e in steps)]
    if not ratios:
        return None
    return sum(ratios) / len(ratios)
