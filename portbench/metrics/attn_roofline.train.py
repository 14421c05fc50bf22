"""attn_roofline.train: kernels 3 and 5 (the flash forward, its remat
recompute, and the backward) in the traced steps: the sum of their frozen
bounds over the sum of their traced device time, in percent.  A launch of
the forward is a ``flash_fwd_mma_kernel``; one of the backward a
``dq_mma_kernel``, whose time adds that of ``dkv_mma_kernel`` and
``dkv_sum_kernel``.  Every launch in these cells is at the cell's whole
local shape (batch rows of the rank, the sequence, the heads)."""
from benchlib import layout, roofline


def read(view):
    if view.trace is None or view.kind != "train":
        return None
    m = view.model
    b = view.traffic["rows"] // view.chips
    s = view.traffic["seq"]
    args = (b, s, m["n_heads"], m["n_kv_heads"], layout.head_dim(m))
    n_fwd, t_fwd = view.trace.time_of(lambda n: "flash_fwd_mma_kernel" in n)
    n_bwd, _ = view.trace.time_of(lambda n: "dq_mma_kernel" in n)
    _, t_bwd = view.trace.time_of(
        lambda n: any(k in n for k in ("dq_mma_kernel", "dkv_mma_kernel",
                                       "dkv_sum_kernel")))
    if not (n_fwd and n_bwd) or t_fwd + t_bwd <= 0:
        return None
    bound = n_fwd * roofline.flash_fwd_s(*args) + \
        n_bwd * roofline.flash_bwd_s(*args)
    return 100.0 * bound / (t_fwd + t_bwd)
