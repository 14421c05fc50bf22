"""The port's spans (``repro_torch/spans.py``) on the CPU: nothing is
recorded or counted without a profiler; under one, a paged engine's
admission and decode steps, a speculative round and a learner step give
their spans with the right nesting, and the prefill chunks their padded
and real positions; a profiler on or off leaves tokens and parameters bit
for bit the same; the buffer stays bounded and counts what it drops."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import llm_a3c, prng  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402

PROMPTS = (11, 16, 19)        # over chunks of 8: 24, 19 and 3 real positions
N_SLOTS, CHUNK, PS = 4, 8, 8
LEAVES = ("engine.map_pages", "engine.logits_to_host", "engine.first_draw",
          "engine.write_rows", "engine.tokens_to_host", "engine.bookkeep",
          "serve.model", "serve.sample", "learner.returns", "learner.grad",
          "learner.update")


@pytest.fixture(autouse=True)
def _clear():
    spans.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    spans.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r.name].append(r)
    return out


def _parents(recs):
    """{id(record): the innermost record that held it open, or None}: the
    latest record opened before it that closed after it (records are kept
    in the order they open, and spans nest)."""
    out = {}
    for i, r in enumerate(recs):
        held = [p for p in recs[:i] if p.end >= r.end]
        out[id(r)] = held[-1] if held else None
        if held:
            assert held[-1].start <= r.start and r.end <= held[-1].end
    return out


def _check_leaves(recs, parents):
    holders = {id(p) for p in parents.values() if p is not None}
    for r in recs:
        assert r.start <= r.end
        if r.name in LEAVES:
            assert id(r) not in holders, r.name


def test_no_profiler_no_record(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span("engine.admit") as s:
        spans.count(rows=3)
    assert s is None
    assert spans.span("serve.model") is spans.span("learner.step")
    assert spans.span("serve.model") is spans._NULL
    assert spans.records() == [] and spans.dropped == 0


def _engine(**kw):
    cfg = get_config("yi-6b").reduced()
    return serve.ServeEngine(cfg, M.init_params(cfg, 0, "cpu"),
                             n_slots=N_SLOTS, cache_len=64, chunk=CHUNK,
                             sample=True, seed=3, page_size=PS,
                             device="cpu", **kw)


def _admit_and_decode(eng, steps=2):
    eng.reset()
    eng.start_clock()
    rng = np.random.default_rng(7)
    for rid, n in enumerate(PROMPTS):
        eng.enqueue(serve.Request(
            rid=rid, prompt=rng.integers(0, 512, n).astype(np.int32),
            max_new=8, arrival=0.0))
    now = eng.now()
    pairs = eng.schedule_admissions(now)
    assert len(pairs) == len(PROMPTS)
    eng.admit(pairs, now)
    for _ in range(steps):
        eng.decode_step_all()
    return [list(r.tokens) for r in eng.req_of if r is not None]


def test_engine_spans_nest_and_count_prefill_positions():
    eng = _engine()
    _, names = _profiled(lambda: _admit_and_decode(eng))
    recs = spans.records()
    by = _by_name(recs)
    parent = _parents(recs)
    for name in ("engine.admit", "engine.map_pages", "engine.prefill_chunk",
                 "engine.logits_to_host", "engine.first_draw",
                 "engine.write_rows", "engine.decode",
                 "engine.tokens_to_host", "engine.bookkeep", "serve.model",
                 "serve.sample"):
        assert spans.PREFIX + name in names, name
        assert by[name], name
    (admit,) = by["engine.admit"]
    assert parent[id(admit)] is None
    for name in ("engine.prefill_chunk", "engine.logits_to_host",
                 "engine.first_draw", "engine.write_rows"):
        assert all(parent[id(r)] is admit for r in by[name]), name
    chunks = by["engine.prefill_chunk"]
    assert [r.counts for r in chunks] == [
        {"computed": len(PROMPTS) * CHUNK, "real": real}
        for real in (24, 19, 3)]
    assert all(not r.counts for r in recs if r.name != "engine.prefill_chunk")
    decodes = by["engine.decode"]
    assert len(decodes) == 2 and all(parent[id(d)] is None for d in decodes)
    assert [parent[id(m)] for m in by["engine.map_pages"]] == \
        [admit] + decodes
    assert [parent[id(m)] for m in by["serve.model"]] == chunks + decodes
    for name in ("serve.sample", "engine.tokens_to_host",
                 "engine.bookkeep"):
        assert [parent[id(r)] for r in by[name]] == decodes, name
    _check_leaves(recs, parent)


def test_speculative_round_is_one_decode_span():
    eng = _engine(spec="ngram", spec_k=3)
    _profiled(lambda: _admit_and_decode(eng, steps=2))
    recs = spans.records()
    by = _by_name(recs)
    parent = _parents(recs)
    decodes = by["engine.decode"]
    assert len(decodes) == 2 and all(parent[id(d)] is None for d in decodes)
    assert [parent[id(m)] for m in by["engine.map_pages"]][1:] == decodes
    _check_leaves(recs, parent)


def test_no_count_without_a_profiler(monkeypatch):
    """The hot path computes no count when nothing records: the engine
    admits and decodes with ``count`` refusing every call."""
    def refuse(**n):
        raise AssertionError(f"counted {n}")
    monkeypatch.setattr(spans, "count", refuse)
    toks = _admit_and_decode(_engine())
    assert all(len(t) == 3 for t in toks)
    assert spans.records() == []


def test_engine_tokens_equal_with_the_profiler_on_and_off():
    off = _admit_and_decode(_engine(), steps=3)
    on, _ = _profiled(lambda: _admit_and_decode(_engine(), steps=3))
    assert on == off and all(len(t) == 4 for t in on)


def _learner():
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cpu")
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = llm_a3c.make_train_step(cfg, opt, lr0=7e-3, total_steps=10)
    batch = TokenPipeline(vocab=cfg.vocab_size, seq_len=32, global_batch=2,
                          device="cpu").batch(prng.key(1), 0)
    return lambda: step(params, state, batch, 0)


def test_learner_step_spans_and_parameters():
    params_off, _, met_off = _learner()()
    (params_on, _, met_on), names = _profiled(_learner())
    recs = spans.records()
    by = _by_name(recs)
    parent = _parents(recs)
    (step,) = by["learner.step"]
    assert parent[id(step)] is None
    for name in ("learner.loss", "learner.grad", "learner.update"):
        assert spans.PREFIX + name in names
        (r,) = by[name]
        assert parent[id(r)] is step
    (loss,) = by["learner.loss"]
    (ret,) = by["learner.returns"]
    assert spans.PREFIX + "learner.returns" in names
    assert parent[id(ret)] is loss
    assert loss.end <= by["learner.grad"][0].start
    assert by["learner.grad"][0].end <= by["learner.update"][0].start
    _check_leaves(recs, parent)
    assert torch.equal(met_on["loss"], met_off["loss"])
    flat_on, flat_off = M.flatten(params_on), M.flatten(params_off)
    assert flat_on.keys() == flat_off.keys()
    assert all(torch.equal(flat_on[k], flat_off[k]) for k in flat_on)


def test_count_goes_to_the_innermost_open_span():
    def body():
        spans.count(lost=1)                   # no span open: nothing
        with spans.span("engine.admit"):
            spans.count(n=1)
            with spans.span("engine.prefill_chunk"):
                spans.count(n=2)
                spans.count(n=3, m=1)
            spans.count(n=4)
    _profiled(body)
    outer, inner = spans.records()
    assert (outer.name, outer.counts) == ("engine.admit", {"n": 5})
    assert (inner.name, inner.counts) == ("engine.prefill_chunk",
                                          {"n": 5, "m": 1})
    assert spans._open == []


def test_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=4))

    def ten():
        for i in range(10):
            with spans.span("engine.decode"):
                spans.count(tokens=i)
    _profiled(ten)
    recs = spans.records()
    assert [r.counts["tokens"] for r in recs] == [6, 7, 8, 9]
    assert spans.dropped == 6
    assert spans.records(recs[1].start, recs[2].end) == recs[1:3]
    spans.clear()
    assert spans.records() == [] and spans.dropped == 0
