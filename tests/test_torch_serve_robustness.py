"""The port's overload handling against the JAX engine on the CPU.

Reservation admission, preempt-and-requeue, deadlines with retries and the
deterministic ``FaultPlan``, on the JAX package's pressure trace (a shared
one-page prefix, rids 1 and 2 with identical prompts, generations that
cross into a third page of 64 rows) with reduced yi-6b and the JAX
package's parameters (bridged).  Recovery must not show in the output: a
preempted request resumes with the uncontended run's greedy tokens, and
the port's engine emits the JAX engine's tokens with its preemption,
requeue, shed, retry, COW and page counters, its virtual clock, and books
that balance.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

PS = 64
ENGINE = dict(n_slots=2, cache_len=3 * PS, chunk=PS, sample=False, seed=0,
              page_size=PS, clock=lambda: 0.0)
PLAN = dict(fail_alloc_at=frozenset({1, 3, 8, 15, 22, 30}),
            preempt_at=(6, 40), latency_at=((3, 0.2), (10, 0.1)),
            hold_pages=1)
# (trace seed, engine arguments, fault plan: None, "explicit", "random")
RUNS = {
    "ample": (0, {}, None),
    "tight": (0, dict(n_pages=5, admission="optimistic"), None),
    "reserve": (0, dict(n_pages=5, admission="reserve"), None),
    "explicit": (1, dict(admission="optimistic"), "explicit"),
    "random": (0, dict(n_pages=5, admission="optimistic"), "random"),
}
COUNTERS = ("preemptions", "requeues", "sheds_admission", "sheds_decode",
            "retries", "admission_alloc_failures", "injected_alloc_failures",
            "forced_preemptions", "cow_events", "pages_requested",
            "pages_alloced", "prefill_chunks_skipped", "step_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engines run thousands of small ops, which intra-op threads only
    slow (several test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    cj = jax_config("yi-6b").reduced()
    ct = torch_config("yi-6b").reduced()
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return cj, ct, pj, pt


def _pressure_trace(mod, vocab, *, n=4, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, PS).astype(np.int32)
    dup = rng.integers(0, vocab, 9).astype(np.int32)
    out = []
    for rid in range(n):
        tail = dup if rid in (1, 2) else rng.integers(
            0, vocab, 5 + (rid % 3) * 6).astype(np.int32)
        out.append(mod.Request(rid=rid, prompt=np.concatenate([shared, tail]),
                               max_new=PS, arrival=0.0))
    return out


def _plan(mod, which):
    if which == "explicit":
        return mod.FaultPlan(**PLAN)
    return mod.FaultPlan.random(0) if which == "random" else None


def _drive(eng, trace, max_iters=5000):
    """The engine's scheduling loop: enqueue everything, then schedule,
    admit and decode, moving the virtual clock only when idle."""
    eng.start_clock()
    for r in trace:
        eng.enqueue(r)
    expect = len(eng.queue) + sum(r is not None for r in eng.req_of)
    done = []
    for _ in range(max_iters):
        if len(done) + len(eng.shed_requests) >= expect:
            return done
        now = eng.now()
        done.extend(eng.admit(eng.schedule_admissions(now), now))
        if any(r is not None for r in eng.req_of):
            done.extend(eng.decode_step_all())
        elif eng.queue:
            nxt = min(r.eff_arrival for r in eng.queue)
            eng.advance(max(nxt - eng.now(), 1e-3))
        else:
            break
    raise AssertionError(f"engine wedged: {len(done)} done, "
                         f"{len(eng.shed_requests)} shed, "
                         f"queue={len(eng.queue)} of {expect}")


def _summary(eng, trace):
    """Tokens, counters, clock and books of a drained engine."""
    al = eng.alloc
    return {"tokens": {r.rid: list(r.tokens) for r in trace},
            "preempted": {r.rid: r.preemptions for r in trace},
            "counters": {k: int(getattr(eng, k)) for k in COUNTERS},
            "now": eng.now(), "high_water": int(al.high_water),
            "used": al.used_pages, "reserved": al.reserved,
            "held": list(eng._fault_held)}


def _assert_books_balanced(eng):
    """Every page back on the free list once, except those the fault plan
    holds; no reservation, no reference left."""
    al = eng.alloc
    held = set(eng._fault_held)
    assert al.reserved == 0 and int(eng.resv_of.sum()) == 0
    assert al.used_pages == len(held)
    assert len(set(al.free)) == len(al.free) and 0 not in al.free
    assert not set(al.free) & held
    assert all(int(al.ref[p]) == (p in held) for p in range(1, al.n_pages))


@pytest.fixture(scope="module")
def jax_runs(models):
    cj, _, pj, _ = models
    out = {}
    for name, (seed, kw, plan) in RUNS.items():
        eng = jax_serve.ServeEngine(cj, pj, fault_plan=_plan(jax_serve, plan),
                                    **ENGINE, **kw)
        trace = _pressure_trace(jax_serve, cj.vocab_size, seed=seed)
        _drive(eng, trace)
        out[name] = _summary(eng, trace)
    return out


def _port_run(models, name):
    _, ct, _, pt = models
    seed, kw, plan = RUNS[name]
    eng = serve.ServeEngine(ct, pt, fault_plan=_plan(serve, plan),
                            device="cpu", **ENGINE, **kw)
    trace = _pressure_trace(serve, ct.vocab_size, seed=seed)
    _drive(eng, trace)
    _assert_books_balanced(eng)
    return eng, trace, _summary(eng, trace)


def test_preemption_token_identity(models, jax_runs):
    """Optimistic admission on an undersized pool preempts and requeues,
    and every request still emits the ample pool's greedy tokens, as the
    JAX engine's do; reserve admission on the same pool never preempts."""
    _, _, ample = _port_run(models, "ample")
    eng, trace, tight = _port_run(models, "tight")
    _, _, resv = _port_run(models, "reserve")
    assert ample == jax_runs["ample"] and ample["counters"]["preemptions"] == 0
    assert tight == jax_runs["tight"]
    assert tight["counters"]["preemptions"] >= 1
    assert any(r.preemptions > 0 for r in trace) and not eng.shed_requests
    assert tight["tokens"] == ample["tokens"]
    assert eng.alloc.high_water <= 4
    assert resv == jax_runs["reserve"]
    assert resv["counters"]["preemptions"] == 0
    assert resv["tokens"] == ample["tokens"]


@pytest.mark.parametrize("name", ["explicit", "random"])
def test_fault_plan_run_matches_jax(models, jax_runs, name):
    """Injected allocation failures (admission mapping, decode growth),
    forced preemptions, virtual latency and held pages: the JAX engine's
    tokens, counters, clock and books; the tokens are the fault-free
    run's."""
    eng, _, got = _port_run(models, name)
    assert got == jax_runs[name]
    c = got["counters"]
    assert c["injected_alloc_failures"] >= 1 and c["forced_preemptions"] >= 1
    assert got["now"] > 0.0
    want = jax_runs["ample" if RUNS[name][0] == 0 else "explicit"]["tokens"]
    assert got["tokens"] == want
    if name == "explicit":
        assert eng.usable_pages == eng.n_pages - 2      # one page held
    al = eng.alloc
    eng.reset()
    assert eng.alloc is not al and eng.alloc.reserved == 0
    assert eng.alloc.used_pages == len(eng._fault_held)


def _admission_unwind(mod, cfg, params):
    """A 2-page prompt whose second page allocation (global call 1) is
    injected to fail, then a clean drive."""
    kw = dict(n_slots=2, cache_len=128, chunk=64, sample=False, seed=0,
              page_size=PS, clock=lambda: 0.0)
    if mod is serve:
        kw["device"] = "cpu"
    req = mod.Request(rid=0, prompt=np.arange(70, dtype=np.int32) % 97,
                      max_new=6, arrival=0.0)
    eng = mod.ServeEngine(cfg, params,
                          fault_plan=mod.FaultPlan(fail_alloc_at=frozenset(
                              {1})), **kw)
    eng.enqueue(req)
    pairs = eng.schedule_admissions(0.0)
    reserved = eng.alloc.reserved
    done = eng.admit(pairs, 0.0)
    state = dict(pairs=len(pairs), reserved=reserved, done=len(done),
                 injected=eng.injected_alloc_failures,
                 failures=eng.admission_alloc_failures,
                 requeues=eng.requeues, queue=[r.rid for r in eng.queue],
                 used=eng.alloc.used_pages, reserved_after=eng.alloc.reserved,
                 unmapped=bool((eng.pt_host == -1).all()),
                 requested=eng.pages_requested,
                 ref=eng.alloc.ref.tolist())
    done = _drive(eng, [])
    state["tokens"] = [list(r.tokens) for r in done]
    return eng, state


def test_admission_unwind_restores_refcounts(models):
    cj, ct, pj, pt = models
    eng, got = _admission_unwind(serve, ct, pt)
    _, want = _admission_unwind(jax_serve, cj, pj)
    assert got == want
    assert (got["pairs"], got["reserved"], got["done"]) == (1, 2, 0)
    assert got["injected"] == got["failures"] == got["requeues"] == 1
    assert got["queue"] == [0] and got["used"] == 0
    assert got["reserved_after"] == 0 and got["unmapped"]
    assert got["requested"] == 0 and not any(got["ref"])
    _assert_books_balanced(eng)


def _deadlines(mod, cfg, params):
    """The JAX package's deadline scenarios on one engine each: a TTFT
    shed, its retry with backoff and its terminal shed; a request admitted
    in time; a total-deadline shed mid-decode."""
    kw = dict(n_slots=1, cache_len=128, chunk=64, sample=False, seed=0,
              page_size=PS, clock=lambda: 0.0)
    if mod is serve:
        kw["device"] = "cpu"
    eng = mod.ServeEngine(cfg, params, retry_backoff=0.05, **kw)
    lag = mod.Request(rid=1, prompt=np.zeros(8, np.int32), max_new=4,
                      arrival=0.0, deadline_ttft=0.5, max_retries=1)
    eng.enqueue(lag)
    log = [eng.schedule_admissions(2.0), eng.retries, lag.retry_count,
           lag.eff_arrival, eng.schedule_admissions(2.01),
           eng.schedule_admissions(5.0), lag.shed_reason,
           eng.sheds_admission, len(eng.queue), len(eng.queue_depths)]
    ok = mod.Request(rid=2, prompt=np.zeros(8, np.int32), max_new=2,
                     arrival=5.0, deadline_ttft=0.5)
    eng.enqueue(ok)
    log.append([r.rid for r, _ in eng.schedule_admissions(5.1)])
    eng = mod.ServeEngine(cfg, params, **kw)
    eng.start_clock()
    req = mod.Request(rid=0, prompt=np.arange(8, dtype=np.int32), max_new=50,
                      arrival=0.0, deadline_total=0.5)
    eng.enqueue(req)
    log.append(eng.admit(eng.schedule_admissions(0.0), 0.0))
    eng.decode_step_all()
    n_before = len(req.tokens)
    eng.advance(1.0)
    log += [eng.decode_step_all(), req.shed_reason, eng.sheds_decode,
            len(req.tokens) - n_before, req.t_done, eng.req_of[0],
            list(req.tokens), eng.alloc.used_pages]
    return log


def test_deadline_sheds_and_retries_match_jax(models):
    cj, ct, pj, pt = models
    got = _deadlines(serve, ct, pt)
    assert got == _deadlines(jax_serve, cj, pj)
    assert got[1:4] == [1, 1, pytest.approx(2.05)]
    assert got[6:8] == ["ttft-deadline", 2] and got[10] == [2]
    assert got[13:16] == ["total-deadline", 1, 1] and got[-1] == 0


def test_run_engine_with_deadlines_matches_jax(models):
    """``run_engine`` on a virtual clock: one slot, four requests at t=0,
    a TTFT deadline every other request misses, one retry each, 10 ms of
    injected latency a step and a total deadline that sheds the longest;
    the report's robustness block, the sheds and the tokens are the JAX
    engine's."""
    cj, ct, pj, pt = models

    def run(mod, cfg, params, **dev):
        trace = mod.gen_trace(4, vocab=cfg.vocab_size, prompt_range=(8, 40),
                              gen_range=(4, 12), arrival_rate=0.0, seed=4)
        for r in trace:
            r.deadline_ttft, r.max_retries = 0.12, 1
        trace[3].deadline_total = 0.05
        plan = mod.FaultPlan(latency_at=tuple((s, 0.01)
                                              for s in range(200)))
        rep = mod.run_engine(cfg, params, trace, n_slots=1, cache_len=64,
                             chunk=16, sample=False, seed=0, page_size=16,
                             fault_plan=plan, clock=lambda: 0.0,
                             retry_backoff=0.05, **dev)
        return rep, {r.rid: (list(r.tokens), r.shed_reason, r.retry_count)
                     for r in trace}

    rep, got = run(serve, ct, pt, device="cpu")
    rep_j, want = run(jax_serve, cj, pj)
    assert got == want
    assert rep["robustness"] == rep_j["robustness"]
    assert rep["wall_s"] == rep_j["wall_s"]
    rob = rep["robustness"]
    assert rob["sheds_admission"] > 0 and rob["retries"] > 0
    assert rob["sheds_decode"] > 0


def test_fault_plan_json_matches_jax():
    plan = dict(fail_alloc_at=frozenset({2, 7}), preempt_at=(5, 5, 9),
                latency_at=((3, 0.5), (3, 0.25), (4, 0.1)), hold_pages=2)
    p, pj = serve.FaultPlan(**plan), jax_serve.FaultPlan(**plan)
    assert p.to_json() == pj.to_json()
    assert serve.FaultPlan.from_json(pj.to_json()) == p
    json.loads(p.to_json())
    assert p.alloc_fails(2) and not p.alloc_fails(3)
    assert p.forced_preempts(5) == 2 and p.forced_preempts(6) == 0
    assert p.step_latency(3) == pytest.approx(0.75)
    for seed in (0, 3, 4):
        a, b = serve.FaultPlan.random(seed), jax_serve.FaultPlan.random(seed)
        assert a.to_json() == b.to_json()
    assert serve.FaultPlan.random(3) != serve.FaultPlan.random(4)


def test_allocator_reservation_accounting():
    """The JAX package's reservation walk, on both allocators."""
    for mod in (serve, jax_serve):
        al = mod.PageAllocator(5)
        assert not al.reserve(5) and al.reserved == 0
        assert al.reserve(3) and al.free_unreserved == 1
        p1 = al.try_alloc()
        assert p1 is not None and al.try_alloc() is None
        assert al.try_alloc(reserved=True) is not None and al.reserved == 2
        assert not al.reserve(1)
        al.unreserve(2)
        with pytest.raises(RuntimeError, match="exceeds outstanding"):
            al.unreserve(1)
        with pytest.raises(RuntimeError, match="out of sync"):
            al.try_alloc(reserved=True)
        while al.try_alloc() is not None:
            pass
        with pytest.raises(RuntimeError, match="page pool exhausted"):
            al.alloc()
        al.decref(p1)
        assert al.high_water == 4 and p1 in al.free


def test_validate_trace_worst_case_page_demand():
    for mod in (serve, jax_serve):
        big = mod.Request(rid=0, prompt=np.zeros(100, np.int32), max_new=92,
                          arrival=0.0)
        mod._validate_trace([big], 192, page_size=PS, usable_pages=3)
        with pytest.raises(ValueError, match="can never be served"):
            mod._validate_trace([big], 192, page_size=PS, usable_pages=2)
        mod._validate_trace([big], 192)


def test_cli_overload_flags_on_cpu(capsys):
    """The CLI's paged and overload flags: a page size rounded to 128, an
    optimistic pool of 5 pages, a fault plan as JSON."""
    plan = serve.FaultPlan(fail_alloc_at=frozenset({0}), hold_pages=1)
    serve.main(["--device", "cpu", "--greedy", "--requests", "4",
                "--prompt-range", "4,12", "--gen-range", "2,6",
                "--cache-len", "256", "--page-size", "100", "--pages", "6",
                "--admission", "optimistic", "--deadline-ttft", "30",
                "--max-retries", "1", "--fault-plan", plan.to_json()])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["paged"] and rec["page_size"] == 128 and rec["n_pages"] == 6
    assert rec["usable_pages"] == 4 and rec["requests"] == 4
    rob = rec["robustness"]
    assert rob["admission_policy"] == "optimistic" and rob["fault_plan"]
    assert rob["injected_alloc_failures"] == 1
