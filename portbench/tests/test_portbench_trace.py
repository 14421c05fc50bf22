"""The device trace's reduction: busy time is the union of intervals."""
from benchlib import devtrace


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert devtrace.merge(iv) == [(0, 15), (20, 30)]
    assert devtrace.busy_ns(iv, 0, 100) == 25
    assert devtrace.busy_ns(iv, 8, 22) == 9


def test_trace_shares_and_spans():
    k = [("a_kernel", 100, 200), ("b_kernel", 150, 300),
         ("a_kernel", 500, 600)]
    h = [("portbench.decode", 90, 400), ("cudaLaunchKernel", 95, 96),
         ("cudaLaunchKernel", 120, 121), ("aten::mm", 320, 480),
         ("cudaLaunchKernel", 450, 451)]
    t = devtrace.Trace(k, h, 0, 1000)
    assert t.busy_s() == 300e-9
    assert abs(t.idle_share() - 0.7) < 1e-12
    assert t.time_of(lambda n: n.startswith("a_")) == (2, 200e-9)
    assert t.launches_in(t.spans("decode")) == 2
    gaps = t.idle_gaps()
    assert gaps[0] == ["window/python", 400e-9]
    assert ["window/aten::mm", 200e-9] in gaps
    inner = devtrace.Trace(k, h + [("portbench.admit", 0, 120)], 0, 1000)
    assert inner.idle_gaps()[-1] == ["admit/python", 100e-9]
    assert t.top_ops()[0] == ["a_kernel", 200e-9]


def test_mirrored_annotations_are_no_device_operation():
    ev = [("portbench.step", 0, 50, False), ("portbench.step", 5, 60, True),
          ("nccl:_all_gather_base", 10, 20, False),
          ("nccl:_all_gather_base", 12, 40, True),
          ("ncclDevKernel_AllGather_RING_LL", 12, 40, True),
          ("cudaLaunchKernel", 1, 2, False), ("gemm_kernel", 3, 9, True)]
    dev, host = devtrace.split_events(ev)
    assert dev == [("ncclDevKernel_AllGather_RING_LL", 12, 40),
                   ("gemm_kernel", 3, 9)]
    assert len(host) == 3
