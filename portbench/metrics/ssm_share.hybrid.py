"""ssm_share.hybrid: the device time of the work launched inside the
program's ``model.ssm`` spans (each Mamba-2 mixer call, prefill and
decode) over the traced stretch's busy time, in percent."""


def read(view):
    t = view.trace
    if t is None or not hasattr(t, "busy_in") or t.busy_s() <= 0:
        return None
    if not any(n == "repro_torch.model.ssm" for n, _, _ in t.host):
        return None
    return 100.0 * t.busy_in(("model.ssm",)) / t.busy_s()
