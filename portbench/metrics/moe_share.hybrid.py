"""moe_share.hybrid: the device time of the work launched inside the
program's ``model.moe`` spans (each MoE block: router, held experts,
shared expert) over the traced stretch's busy time, in percent."""


def read(view):
    t = view.trace
    if t is None or not hasattr(t, "busy_in") or t.busy_s() <= 0:
        return None
    if not any(n == "repro_torch.model.moe" for n, _, _ in t.host):
        return None
    return 100.0 * t.busy_in(("model.moe",)) / t.busy_s()
