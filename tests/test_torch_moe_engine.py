"""The port's serve engine on MoE models against the JAX engine, on the
CPU.

Reduced Granite-MoE (2 layers, 4 experts, top-2) and Llama-4-Scout (one
block cycle: three sliding-window layers and a global one, 4 experts,
top-1) with the JAX package's parameters, on one trace with idle slots (6
requests on 4 slots), greedy: at the full configs' capacity factor 1.25
contiguous, paged and with n-gram speculation, and at the reduced factor
8.0 (nothing drops) contiguous.  Tokens identical and counters equal.
Capacity is per call, so padding rows of an admission chunk and idle
slots of a decode step take expert slots ahead of later rows: the port
feeds them the reference's tokens, in the reference's slot order, and
their cache reads see the reference's contents (the warm-up keeps a cache
of its own, as the JAX engine's does).

Token identity across frameworks holds where every choice wins by far
more than the ~1e-6 by which their logits differ; under drops a choice
depends on the whole batch of its call, so the margin is taken on the
port engine's own logits rows, the ones its tokens came from (>= 1e-3).
The CPU's index writes resolve duplicate targets (the sink page that
idle and padding rows write) last-wins on one thread, as XLA's do: the
engines run on one thread.
"""
import dataclasses

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
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS = {}


def _models(arch, cf):
    """(JAX config, port config, JAX params, port params), cached."""
    if (arch, cf) not in _MODELS:
        over = {} if cf is None else dict(capacity_factor=cf)
        cj = dataclasses.replace(jax_config(arch).reduced(), **over)
        ct = dataclasses.replace(torch_config(arch).reduced(), **over)
        pj = JM.init_params(cj, jax.random.key(0))
        pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                    device="cpu")
        _MODELS[arch, cf] = (cj, ct, pj, pt)
    return _MODELS[arch, cf]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# trace seed 2: every choice along the tokens wins by >= 1e-3 (seed 0's
# speculative runs have one won by 4e-4)
TRACE = dict(prompt_range=(3, 20), gen_range=(2, 9), arrival_rate=0.0,
             seed=2)
ENGINE = dict(n_slots=4, cache_len=32, chunk=8, sample=False, seed=0)
MODES = {"contiguous": dict(paged=False), "paged": dict(page_size=8),
         "ngram": dict(paged=False, spec="ngram", spec_k=4)}
KEYS = ("step_count", "prefill_tokens", "decode_tokens", "preemptions",
        "requeues", "spec_rounds", "spec_drafted", "spec_drafts_accepted",
        "pages_requested", "pages_alloced", "cow_events")


class _Margins:
    """The smallest top-2 gap of the port engine's logits rows that chose
    its tokens: each row's last prompt position in a prefill chunk, each
    occupied slot's row of a decode step and each row of an occupied
    slot's verify chunk (the rows past its accepted run too: a bound from
    below).  Installed on the model's steps while the engine serves."""

    def __init__(self, eng):
        self.eng, self.worst = eng, float("inf")

    def _gap(self, row):
        top = torch.topk(row.float(), 2).values.double()
        self.worst = min(self.worst, float(top[0] - top[1]))

    def __enter__(self):
        self.saved = TM.prefill_step, TM.decode_step, TM.verify_step
        prefill, decode, verify = self.saved

        def busy():
            return [j for j, r in enumerate(self.eng.req_of)
                    if r is not None]

        def prefill_w(cfg, params, cache, batch, pos0=0, true_len=None):
            out, cache = prefill(cfg, params, cache, batch, pos0, true_len)
            c = batch["tokens"].shape[1]
            for r, n in enumerate(true_len.tolist()):
                if pos0 <= n - 1 < pos0 + c:
                    self._gap(out["logits"][r, n - 1 - pos0])
            return out, cache

        def decode_w(cfg, params, cache, batch, pos):
            out, cache = decode(cfg, params, cache, batch, pos)
            for j in busy():
                self._gap(out["logits"][j, -1])
            return out, cache

        def verify_w(cfg, params, cache, batch, pos, shift):
            out, pend = verify(cfg, params, cache, batch, pos, shift)
            for j in busy():
                for row in out["logits"][j]:
                    self._gap(row)
            return out, pend

        TM.prefill_step, TM.decode_step, TM.verify_step = \
            prefill_w, decode_w, verify_w
        return self

    def __exit__(self, *exc):
        TM.prefill_step, TM.decode_step, TM.verify_step = self.saved


def _drive(mod, cfg, params, trace, margins=False, **kw):
    if mod is serve:
        kw["device"] = "cpu"
    eng = mod.ServeEngine(cfg, params, **ENGINE, **kw)
    mod._warmup(eng, trace)
    done = []
    eng.start_clock()
    if margins:
        with _Margins(eng) as m:
            mod._drain(eng, sorted(trace, key=lambda r: r.arrival), 0, done)
        eng.margin = m.worst
    else:
        mod._drain(eng, sorted(trace, key=lambda r: r.arrival), 0, done)
    assert len(done) == len(trace)
    return eng, {r.rid: [int(t) for t in r.tokens] for r in trace}


def _counters(eng):
    return {k: getattr(eng, k) for k in KEYS if hasattr(eng, k)}


CASES = [(a, cf, m) for a in ARCHS
         for cf, m in ((None, "contiguous"), (1.25, "contiguous"),
                       (1.25, "paged"), (1.25, "ngram"))]
IDS = [f"{a.split('-')[0]}-cf{cf or 'reduced'}-{m}" for a, cf, m in CASES]


@pytest.mark.parametrize("arch,cf,mode", CASES, ids=IDS)
def test_engine_matches_jax_engine(arch, cf, mode):
    cj, ct, pj, pt = _models(arch, cf)
    kw = MODES[mode]
    eng_j, toks_j = _drive(jax_serve, cj, pj,
                           jax_serve.gen_trace(6, vocab=cj.vocab_size,
                                               **TRACE), **kw)
    eng_t, toks_t = _drive(serve, ct, pt,
                           serve.gen_trace(6, vocab=ct.vocab_size, **TRACE),
                           margins=True, **kw)
    assert eng_t.margin >= 1e-3, f"a near tie along the tokens " \
                                 f"({eng_t.margin})"
    assert toks_t == toks_j
    assert _counters(eng_t) == _counters(eng_j)
    assert eng_t.paged == (mode == "paged")
    # 6 requests on 4 slots: slots stood idle while others decoded
    assert min(eng_t.occupancy) < 1.0
    if mode == "ngram":
        assert eng_t.spec_rounds > 0


def test_warmup_leaves_the_sink_as_the_jax_warmup():
    """After the warm-up, the paged pools' sink page (which idle decode
    rows read: every key of theirs is masked, so they take its mean of v)
    holds what the JAX engine's holds: the warm-up's chunks run on a cache
    of their own, as the JAX engine's do, and only the warm admission and
    decode step write the engine's pools (pages of 16 rows: the warm
    request's 8 prompt rows leave half the sink to the chunks)."""
    cj, ct, pj, pt = _models(ARCHS[0], 1.25)
    kw = dict(page_size=16)
    trace = dict(TRACE, seed=5)
    eng_j = jax_serve.ServeEngine(cj, pj, **ENGINE, **kw)
    jax_serve._warmup(eng_j, jax_serve.gen_trace(6, vocab=cj.vocab_size,
                                                 **trace))
    eng_t = serve.ServeEngine(ct, pt, **ENGINE, **kw, device="cpu")
    serve._warmup(eng_t, serve.gen_trace(6, vocab=ct.vocab_size, **trace))
    layers = eng_j.cache["layers"]
    for i, layer in enumerate(eng_t.cache["layers"]):
        for name in ("kp", "vp"):
            want = np.asarray(layers[i % len(cj.block_cycle)][name][
                i // len(cj.block_cycle)][0]) \
                if isinstance(layers, tuple) else np.asarray(
                    layers[i][name][0])
            np.testing.assert_allclose(layer[name][0].numpy(), want,
                                       rtol=2e-4, atol=2e-4)
