"""mfu.hybrid: the window's least time over its wall, in percent, for a
Mamba-2 / attention / MoE policy.  The least time sums, over the window's
prefill chunks and decode steps, the longer of their useful FLOPs over
the bf16 peak and their useful bytes over the HBM peak
(``roofline_hybrid.prefill_least_s``, ``decode_least_s``): real prompt
rows, the held experts the tokens hit, the scan's state read and written,
the attention layers' KV."""


def read(view):
    least = getattr(view, "hybrid_least_s", None)
    if least is None or view.window_s <= 0:
        return None
    return 100.0 * least / view.window_s
