"""kernels_per_decode_step.rollout: the kernel launches the host made
inside the benchmark's spans around ``decode_step_all`` in the traced
stretch, per decode step."""


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    spans = view.trace.spans("decode")
    if not spans:
        return None
    return view.trace.launches_in(spans) / len(spans)
