"""ssd_roofline.hybrid: the Mamba-2 scans' share of their roofline over
the traced stretch: the sum, over the program's ``model.ssm`` records, of
the scan's frozen bound from its counts (``roofline_hybrid.ssd_s``: rows,
positions, masked) over the device time of the work launched inside the
``model.ssm`` spans, in percent.  That time holds the whole mixer call
(its projections, conv and gated norm beside the scan), so the reading
is at most the scan's own share."""
from benchlib import roofline_hybrid, spans


def read(view):
    t = view.trace
    if t is None or not hasattr(t, "busy_in"):
        return None
    recs = [r for r in spans.records(t, "model.ssm") if "rows" in r.counts]
    busy = t.busy_in(("model.ssm",))
    if not recs or busy <= 0:
        return None
    bound = sum(roofline_hybrid.ssd_s(view.model, r.counts["rows"],
                                      r.counts["positions"],
                                      r.counts["masked"]) for r in recs)
    return 100.0 * bound / busy
