"""device_idle.train: the share of the learner's traced steps in which no
operation ran on the card (the union of device intervals, overlapping
streams counted once), in percent."""


def read(view):
    if view.trace is None or view.kind != "train":
        return None
    return 100.0 * view.trace.idle_share()
