"""device_idle.rollout: the share of the traced stretch of the closed
loop in which no operation ran on the card (the union of device
intervals, overlapping streams counted once), in percent."""


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return 100.0 * view.trace.idle_share()
