"""The readers of the program's spans: the card's idle time inside named
spans and split by the innermost one, and the padded against real prefill
positions, on synthetic traces and records, on the drivers' traced runs at
a size a test run holds, and on the card, where a span's host sleep
between two kernels must read as the card's idle time inside it."""
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchlib import bench, devtrace
from benchlib import spans

CPU = torch.device("cpu")
P = spans.PREFIX


def _trace(host, start=0, end=1000):
    k = [("a_kernel", 100, 200), ("b_kernel", 150, 180),
         ("a_kernel", 400, 500), ("a_kernel", 900, 1000)]
    return devtrace.Trace(k, host, start, end)


HOST = [("portbench.decode", 40, 960), (P + "engine.decode", 50, 950),
        (P + "serve.model", 150, 450), ("cudaLaunchKernel", 160, 161),
        (P + "serve.sample", 600, 700), ("aten::mm", 610, 620)]


def test_idle_inside_named_spans():
    t = _trace(HOST)
    assert spans.idle_intervals(t) == [(0, 100), (200, 400), (500, 900)]
    assert spans.idle_s(t, ("serve.model",)) == 200e-9
    assert spans.idle_s(t, ("serve.sample",)) == 100e-9
    assert spans.idle_s(t, ("serve.model", "serve.sample")) == 300e-9
    assert spans.idle_s(t, ("engine.decode",)) == 650e-9
    assert spans.idle_share(t, ("serve.model",)) == pytest.approx(20.0)
    assert spans.idle_s(t, ("engine.first_draw",)) is None
    assert spans.idle_share(t, ("engine.first_draw",)) is None


def test_spans_are_clipped_to_the_stretch():
    t = _trace([(P + "engine.first_draw", -300, 50),
                (P + "engine.first_draw", 980, 1200)])
    assert spans.idle_s(t, ("engine.first_draw",)) == 50e-9


def test_idle_split_by_innermost_span():
    t = _trace(HOST)
    assert spans.innermost(t) == [
        (50, 150, "engine.decode"), (150, 450, "serve.model"),
        (450, 600, "engine.decode"), (600, 700, "serve.sample"),
        (700, 950, "engine.decode")]
    split = spans.idle_by_span(t)
    assert split == pytest.approx({"": 50e-9, "engine.decode": 350e-9,
                                   "serve.model": 200e-9,
                                   "serve.sample": 100e-9}, abs=1e-15)
    assert sum(split.values()) == pytest.approx(1e-9 * 700)


def test_idle_per_instance_of_another_span():
    host = HOST + [(P + "engine.decode", 960, 1100),
                   (P + "serve.sample", 970, 990),
                   (P + "serve.model", 0, 40)]       # outside every decode
    t = _trace(host)
    # the stretch holds the first decode and a third of the second
    n = 1 + 40 / 140
    assert spans.idle_ms_per(t, ("serve.model",), "engine.decode") == \
        pytest.approx(200e-6 / n)
    assert spans.idle_ms_per(t, ("serve.sample",), "engine.decode") == \
        pytest.approx(100e-6 / n)
    assert spans.idle_ms_per(t, ("engine.first_draw",),
                             "engine.decode") is None
    assert spans.idle_ms_per(t, ("serve.model",), "engine.admit") is None
    late = _trace(host, start=1200, end=1300)
    assert spans.idle_ms_per(late, ("serve.model",), "engine.decode") is None


def _view(kind, trace):
    return SimpleNamespace(kind=kind, trace=trace,
                           window_s=trace.window_s if trace else 1.0)


@pytest.mark.parametrize("name,kind,want", [
    ("model_idle.rollout", "rollout", 20.0),
    ("sample_idle.rollout", "rollout", 10.0),
    ("first_draw_idle.rollout", "rollout", None),
    ("model_idle.train", "train", None),
    ("model_idle_ms.rollout", "rollout", 200e-6),
    ("sample_idle_ms.rollout", "rollout", 100e-6),
    ("first_draw_idle_ms.rollout", "rollout", None)])
def test_idle_readers(name, kind, want):
    read = bench.reader(name)
    got = read(_view(kind, _trace(HOST)))
    assert got == (None if want is None else pytest.approx(want))
    assert read(_view(kind, None)) is None
    other = "train" if kind == "rollout" else "rollout"
    assert read(_view(other, _trace(HOST))) is None


def test_train_reader_takes_loss_and_grad():
    t = _trace([(P + "learner.step", 0, 1000), (P + "learner.loss", 50, 150),
                (P + "learner.returns", 60, 90),
                (P + "learner.grad", 150, 450),
                (P + "learner.update", 450, 980)])
    assert bench.reader("model_idle.train")(_view("train", t)) == \
        pytest.approx(25.0)


def _chunks(counts):
    from repro_torch import spans as program
    program.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for computed, real in counts:
            with program.span("engine.prefill_chunk"):
                program.count(computed=computed, real=real)
            with program.span("serve.model"):
                program.count(real=1000)
    return program.records()


def test_pad_ratio_from_the_program_records():
    read = bench.reader("prefill_pad_ratio.rollout")
    recs = _chunks([(256, 24), (256, 19), (256, 3), (128, 100)])
    inside = devtrace.Trace([], [], recs[0].start, recs[5].end)
    assert read(_view("rollout", inside)) == pytest.approx(768 / 46)
    whole = devtrace.Trace([], [], recs[0].start, recs[-1].end)
    assert read(_view("rollout", whole)) == pytest.approx(896 / 146)
    assert read(_view("rollout", None)) is None
    assert read(_view("train", whole)) is None
    later = devtrace.Trace([], [], recs[-1].end + 1, recs[-1].end + 10)
    assert read(_view("rollout", later)) is None


def test_pad_ratio_without_the_program_spans(monkeypatch):
    import repro_torch
    _chunks([(256, 24)])
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    whole = devtrace.Trace([], [], 0, time.time_ns() + 10 ** 9)
    assert spans.records(whole, "engine.prefill_chunk") == []
    assert bench.reader("prefill_pad_ratio.rollout")(
        _view("rollout", whole)) is None


SPAN_METRICS = ("prefill_pad_ratio.rollout", "first_draw_idle.rollout",
                "sample_idle.rollout", "model_idle.rollout")
PER_METRICS = ("first_draw_idle_ms.rollout", "sample_idle_ms.rollout",
               "model_idle_ms.rollout")


def test_traced_rollout_reads_every_span_metric(rollout_cell):
    drv = bench.load_module(bench.HERE / "drivers" / "rollout.py",
                            "pb_spans_r")
    out = drv.run(rollout_cell(), 2 ** 31 + 17, 0.3, True, CPU, 0.0)
    view = out["view"]
    idle = bench.reader("device_idle.rollout")(view)
    got = {m: bench.reader(m)(view) for m in SPAN_METRICS}
    assert all(v is not None for v in got.values()), got
    assert got["prefill_pad_ratio.rollout"] >= 1.0
    for m in SPAN_METRICS[1:]:
        assert 0.0 < got[m] <= idle, (m, got, idle)
    per = {m: bench.reader(m)(view) for m in PER_METRICS}
    assert all(v is not None and v > 0.0 for v in per.values()), per


def test_traced_learner_reads_model_idle(train_cell):
    drv = bench.load_module(bench.HERE / "drivers" / "learner.py",
                            "pb_spans_t")
    out = drv.run(train_cell(), 2 ** 31 + 19, 0.2, True, CPU, 0.0)
    view = out["view"]
    got = bench.reader("model_idle.train")(view)
    assert got is not None
    assert 0.0 < got <= bench.reader("device_idle.train")(view)


@pytest.mark.card
def test_host_sleep_in_a_span_is_the_card_idle_inside_it(card):
    from repro_torch import spans as program
    x = torch.randn(2048, 2048, device=card)

    def body():
        x @ x
        torch.cuda.synchronize(card)
        with program.span("bench.sleep"):
            time.sleep(0.020)
        x @ x
    body()
    trace = devtrace.capture(body, lambda: torch.cuda.synchronize(card))
    idle = spans.idle_s(trace, ("bench.sleep",))
    assert idle is not None and 0.018 <= idle <= 0.022, idle
    assert len(trace.kernels) >= 2
