"""prefill_pad_ratio.rollout: the prefill positions the engine computed
over the real prompt positions among them, over the ``engine.prefill_chunk``
spans of the traced stretch: each chunk run counts its rows times its
length as computed and the admitted rows' prompt positions in it as
real."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    recs = spans.records(view.trace, "engine.prefill_chunk")
    real = sum(r.counts.get("real", 0) for r in recs)
    if not real:
        return None
    return sum(r.counts.get("computed", 0) for r in recs) / real
