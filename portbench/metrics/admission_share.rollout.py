"""admission_share.rollout: the share of the window the engine spent in
``admit`` (the benchmark's spans around each call: the padded group
prefill and its page mapping), in percent."""


def read(view):
    if view.kind != "rollout" or view.window_s <= 0:
        return None
    return 100.0 * view.admit_s / view.window_s
