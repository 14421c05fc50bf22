"""decode_attn_roofline.rollout: kernels 4 (the paged chunked prefill's
append) and 6 (the paged decode) in the traced stretch: the sum of their
frozen bounds over the real rows of each launch (``roofline.append_s``,
``decode_s``) over the sum of their traced device time, in percent.
Kernel 4 is ``append_mma_kernel``; kernel 6 ``decode_split_kernel`` and
its ``decode_combine_kernel``."""


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    names = ("append_mma_kernel", "decode_split_kernel",
             "decode_combine_kernel")
    n, t = view.trace.time_of(lambda k: any(x in k for x in names))
    if not n or t <= 0:
        return None
    return 100.0 * view.kernel_bound_s / t
