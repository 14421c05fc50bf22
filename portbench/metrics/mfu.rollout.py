"""mfu.rollout: the window's least time over its wall, in percent.  The
least time sums, over the prefill chunks and decode steps of the window,
the longer of their useful FLOPs over the bf16 peak and their useful
bytes over the HBM peak (``roofline.prefill_least_s``,
``decode_least_s``): real prompt rows and live cache rows only, never
padding."""


def read(view):
    if view.kind != "rollout" or view.window_s <= 0:
        return None
    return 100.0 * view.least_s / view.window_s
