"""The actors' cells: the serving engine (``launch/serve.py::ServeEngine``)
under a closed loop of actors.

Each actor sends a request (a prompt: its episode's context; a sampled
segment of action tokens: the generation), waits for the whole segment
and at once sends its next; there is no think time.  The loop is a copy
of ``launch/serve.py::_drain`` in which a completion, not a clock, issues
the next request, so a seed gives the same schedule on any card.  Lengths
come from a fixed set that every block of ``actors`` consecutive requests
holds whole, in an order drawn from the seed: seeds change the order of
the work, not its amount.

Set-up makes bf16 weights on the card from the seed, builds the engine
and runs its own warm-up (every prefill chunk offset the traffic reaches,
one admission, one decode step).  The window runs the loop for
``seconds``; ITL gaps and first-token times are taken on the host clock
when the engine returns (it returns after the tokens reach the host).
After the window the engine is freed and a sample of the finished
requests, drawn from the seed with the longest among them, is judged by
the float32 reference (``reference/serve.py``).

Traffic keys: actors, slots, cache_len, chunk, page_size, pages,
prompt (lo, hi), gen (lo, hi), check_tokens (served tokens judged),
trace_seconds (the profiled stretch of a traced run).
"""
from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchlib import bench, compare, devtrace, faults, roofline, weights
from benchlib import layout as lay_mod
from benchlib.port import check_layout, port_config
from reference import serve as ref_serve

M32 = 0xFFFFFFFF


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Actors:
    """The request stream: request i has a prompt of ``prompt`` lengths and
    a segment of ``gen`` tokens, from a grid of ``actors`` evenly spaced
    lengths that each block of ``actors`` requests holds once, in an order
    drawn from (seed, block)."""

    def __init__(self, seed: int, tr: dict, vocab: int):
        self.seed, self.vocab, self.n = seed, vocab, tr["actors"]
        self.plens = np.linspace(*tr["prompt"], self.n).round().astype(int)
        self.glens = np.linspace(*tr["gen"], self.n).round().astype(int)
        self.next_rid = 0
        self._orders: dict = {}

    def _order(self, block: int):
        if block not in self._orders:
            rng = np.random.default_rng(weights.mix(self.seed, 3, block))
            self._orders[block] = (rng.permutation(self.n),
                                   rng.permutation(self.n))
        return self._orders[block]

    def next(self, arrival: float):
        from repro_torch.launch import serve
        rid = self.next_rid
        self.next_rid += 1
        block, i = divmod(rid, self.n)
        po, go = self._order(block)
        rng = np.random.default_rng(weights.mix(self.seed, 4, rid))
        prompt = rng.integers(0, self.vocab, int(self.plens[po[i]]))
        return serve.Request(rid=rid, prompt=prompt.astype(np.int32),
                             max_new=int(self.glens[go[i]]), arrival=arrival)


class Loop:
    """The closed loop over one engine, with the benchmark's books:
    arrival and first-token times, each token's gap, the admissions'
    host time and the records the least-time and roofline arithmetic
    reads."""

    def __init__(self, eng, actors, clock=time.perf_counter):
        self.eng, self.actors, self.clock = eng, actors, clock
        self.issued, self.done = [], []
        self.arrive, self.first, self.last = {}, {}, {}
        self.gaps = []
        self.admit_s = 0.0
        self.prefills, self.decodes = [], []
        self.annotate = False

    def issue(self):
        req = self.actors.next(self.eng.now())
        self.eng.enqueue(req)
        self.issued.append(req)
        self.arrive[req.rid] = self.clock()

    def start(self):
        self.eng.reset()
        self.eng.start_clock()
        for _ in range(self.actors.n):
            self.issue()

    def _finish(self, reqs):
        for r in reqs:
            self.done.append(r)
            self.issue()

    def _span(self, what):
        if self.annotate:
            return torch.profiler.record_function("portbench." + what)
        return contextlib.nullcontext()

    def step(self):
        eng = self.eng
        now = eng.now()
        pairs = eng.schedule_admissions(now)
        if pairs:
            self.prefills.append([len(r.prompt) + len(r.tokens)
                                  for r, _ in pairs])
            t0 = self.clock()
            with self._span("admit"):
                fin = eng.admit(pairs, now)
            t1 = self.clock()
            self.admit_s += t1 - t0
            for r, _ in pairs:
                self.first.setdefault(r.rid, t1)
                self.last[r.rid] = t1
            self._finish(fin)
        active = [r for r in eng.req_of if r is not None]
        if not active:
            return
        self.decodes.append([int(eng.pos[j]) + 1
                             for j, r in enumerate(eng.req_of)
                             if r is not None])
        with self._span("decode"):
            fin = eng.decode_step_all()
        t = self.clock()
        for r in active:
            self.gaps.append(t - self.last[r.rid])
            self.last[r.rid] = t
        self._finish(fin)

    def run_for(self, seconds: float) -> float:
        t0 = self.clock()
        while self.clock() - t0 < seconds:
            self.step()
        return self.clock() - t0

    def open_gaps(self, t_end):
        """Gaps still open at ``t_end``: each slot's wait for its next
        token."""
        return [t_end - self.last[r.rid] for r in self.eng.req_of
                if r is not None]

    def ttfts(self, t_end):
        return [self.first.get(r.rid, t_end) - self.arrive[r.rid]
                for r in self.issued]


def _dtype(model):
    """The served weights' type: the configuration's compute type."""
    return getattr(torch, model["dtype"])


def build(cell, seed: int, dev):
    from repro_torch.launch import serve
    model, tr = cell["config"]["model"], cell["traffic"]
    cfg = port_config(model)
    lay = lay_mod.layout(model)
    check_layout(cfg, lay)
    params = lay_mod.unflatten(weights.make(lay, seed, dev, _dtype(model)))
    bench.mark("weights")
    eng = serve.ServeEngine(
        cfg, params, n_slots=tr["slots"], cache_len=tr["cache_len"],
        chunk=tr["chunk"], sample=True, seed=seed & M32,
        page_size=tr["page_size"], n_pages=tr["pages"], prefix_cache=True,
        kv_dtype="bf16", admission="reserve", device=dev)
    longest = serve.Request(rid=-1, prompt=np.zeros(tr["prompt"][1], np.int32),
                            max_new=tr["gen"][1], arrival=0.0)
    bench.mark("engine")
    serve._warmup(eng, [longest])
    bench.mark("warm")
    return eng


def _least_s(model, loop, tr) -> float:
    """The window's least time: each prefill chunk's and decode step's
    useful operations over the bf16 peak or useful bytes over the HBM
    peak, whichever is longer, summed."""
    layers = lay_mod.product_params(model) - \
        model["d_model"] * (model["vocab_size"] + 1)
    head = model["d_model"] * (model["vocab_size"] + 1)
    wbytes = roofline.BF16 * (layers + head)
    total = 0.0
    for plens in loop.prefills:
        for p0, c, rows, last in _chunks(plens, tr):
            total += roofline.prefill_least_s(model, rows, last, layers,
                                              head, wbytes)
    for keys in loop.decodes:
        total += roofline.decode_least_s(model, keys, layers, head, wbytes)
    return total


def _chunks(plens, tr):
    """(pos0, length, real rows (pos0, n), rows ending here) of each chunk
    of one admission's padded grid (``serve._chunk_grid``)."""
    c, cache_len = tr["chunk"], tr["cache_len"]
    padded = min(-(-max(plens) // c) * c, cache_len)
    out = []
    for p0 in range(0, padded, c):
        n = min(c, padded - p0)
        rows = [(p0, min(n, pl - p0)) for pl in plens if pl > p0]
        last = sum(1 for pl in plens if p0 < pl <= p0 + n)
        out.append((p0, n, rows, last))
    return out


def _kernel_bounds_s(model, loop_prefills, loop_decodes, tr) -> float:
    """Kernels 4 and 6's frozen bounds over the traced stretch: a launch a
    layer of each prefill chunk and decode step."""
    hq, hkv = model["n_heads"], model["n_kv_heads"]
    d = lay_mod.head_dim(model)
    total = 0.0
    for plens in loop_prefills:
        for _, _, rows, _ in _chunks(plens, tr):
            total += roofline.append_s(rows, hq, hkv, d)
    for keys in loop_decodes:
        total += roofline.decode_s(keys, hq, hkv, d)
    return total * model["n_layers"]


def sample(done, seed: int, tokens: int):
    """The finished requests judged: the longest, then others drawn from
    the seed until ``tokens`` served tokens are in."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(weights.mix(seed, 5))
    picked, n = [longest], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        if n >= tokens:
            break
        picked.append(rest[i])
        n += len(rest[i].tokens)
    return [(r.rid, np.asarray(r.prompt), list(r.tokens)) for r in picked]


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        fault=None) -> dict:
    model, tr = cell["config"]["model"], cell["traffic"]
    eng = build(cell, seed, dev)
    if fault is not None:
        faults.plant(eng, fault)
    loop = Loop(eng, Actors(seed, tr, model["vocab_size"]))
    _sync(dev)
    setup_s = time.time() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.start()
    host = bench.HostClock()
    t0 = loop.clock()
    wall = loop.run_for(seconds)
    t_end = t0 + wall
    host.stop()
    gaps = loop.gaps + loop.open_gaps(t_end)
    gen = sum(len(r.tokens) for r in loop.issued)
    view = SimpleNamespace(
        kind="rollout", model=model, traffic=tr, chips=1, window_s=wall,
        admit_s=loop.admit_s, ttfts=loop.ttfts(t_end),
        least_s=_least_s(model, loop, tr), trace=None, host=host)
    attempted = len(loop.issued)
    if trace:
        n_pre, n_dec = len(loop.prefills), len(loop.decodes)
        loop.annotate = True
        view.trace = devtrace.capture(
            lambda: loop.run_for(tr["trace_seconds"]), lambda: _sync(dev))
        loop.annotate = False
        view.kernel_bound_s = _kernel_bounds_s(
            model, loop.prefills[n_pre:], loop.decodes[n_dec:], tr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = sample(loop.done, seed, tr["check_tokens"])
    del loop, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, dev, judged)
    checks = compare.held({"token_gap": ref["served"]}, cell["limits"])
    checks["tokens_judged"] = {"value": ref["tokens"],
                               "limit": tr["check_tokens"] // 2,
                               "at_least": True}
    return {"attempted": attempted, "failed": 0,
            "correct": compare.passes(checks), "checks": checks,
            "setup_s": setup_s, "memory_peak_bytes": peak,
            "e2e": {"gen_tokens_per_s": gen / wall,
                    "itl_p95_ms": 1e3 * float(np.percentile(gaps, 95)),
                    "setup_s": setup_s},
            "view": view}


def reference(cell, seed: int, dev, judged, lowp=None) -> dict:
    model = cell["config"]["model"]
    f = weights.make(lay_mod.layout(model), seed, dev, _dtype(model))
    out = ref_serve.gaps(model, f, judged, seed & M32, lowp=lowp)
    del f
    gc.collect()
    return out


def calibrate(cell, seed: int, dev, controls: bool, seconds: float):
    """A short window at the cell's load, then the program's widest gap
    and, with ``controls``, the float8 reference's at the same
    positions."""
    from reference import lowp
    tr = cell["traffic"]
    eng = build(cell, seed, dev)
    loop = Loop(eng, Actors(seed, tr, cell["config"]["model"]["vocab_size"]))
    loop.start()
    while len(loop.done) < 8 or loop.clock() - loop.arrive[0] < seconds:
        loop.step()
    judged = sample(loop.done, seed, tr["check_tokens"])
    del loop, eng
    gc.collect()
    torch.cuda.empty_cache()
    out = reference(cell, seed, dev, judged,
                    lowp.fp8 if controls else None)
    yield "program", {"token_gap": out["served"], "tokens": out["tokens"]}
    if controls:
        yield "fp8", {"token_gap": out["control"], "tokens": out["tokens"]}

