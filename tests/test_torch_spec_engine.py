"""The port's speculative serve engine against the JAX engine on the CPU.

Each trace of the JAX package's ``tests/test_spec_decode.py`` (contiguous,
the ring rotation boundary, paged with balanced books, paged int8, the
draft model, sampled streams, a mid-page rejection rewind under wrong
drafts, ``reserve`` keeping rejected pages, a COW fork during verify,
preemption mid-speculation) runs through both engines with speculation
on: the port emits the JAX engine's tokens with its speculative counters
(rounds, drafted, accepted, wasted, pages rewound, each round's accepted
k) and page counters, exactly, and a paged run's books balance.  Token
identity across frameworks holds where every choice wins by far more than
the ~1e-6 by which their logits differ: each test first checks
``min_accept_margin`` >= 1e-3 along the tokens, which also replays plain
decode, so speculation's tokens are plain decode's.
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
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

SPEC_KEYS = ("spec_rounds", "spec_drafted", "spec_drafts_accepted",
             "spec_wasted_tokens", "spec_pages_rewound", "accepted_k",
             "pages_requested", "pages_alloced", "cow_events", "preemptions",
             "requeues", "step_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(**over):
    cj = dataclasses.replace(jax_config("stablelm-1.6b").reduced(), **over)
    ct = dataclasses.replace(torch_config("stablelm-1.6b").reduced(), **over)
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def models():
    return _models()


def _trace(mod, vocab, *, n=4, prompt_range=(12, 24), max_new=16, seed=3,
           shared=0, duplicate=False):
    """The JAX test's trace: an optional shared prefix, distinct tails (or
    one tail for all), staggered generation lengths."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared).astype(np.int32)
    base_tail = rng.integers(0, vocab, prompt_range[0]).astype(np.int32)
    out = []
    for rid in range(n):
        tail = base_tail if duplicate else rng.integers(0, vocab, int(
            rng.integers(prompt_range[0], prompt_range[1] + 1))).astype(
                np.int32)
        out.append(mod.Request(rid=rid, prompt=np.concatenate([pre, tail]),
                               max_new=max_new - (rid % 3) * 2, arrival=0.0))
    return out


class _WrongDraft:
    """Drafts that are always wrong (the vocabulary cycled away from the
    last token): every round rejects its whole draft tail."""

    kind = "wrong"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose_one(self, history, k):
        last = int(history[-1])
        return [(last + 7 * (i + 1)) % self.vocab for i in range(k - 1)]

    def admit(self, req, j):
        pass

    def reset(self):
        pass


def _drive(mod, cfg, params, trace, *, spec, spec_k=4, n_slots=2,
           cache_len=64, chunk=16, sample=False, seed=0, wrong=False,
           draft_params=None, **kw):
    """A trace through a fresh engine of ``mod`` (warm-up, then the serve
    loop); returns (engine, tokens)."""
    if mod is serve:
        kw["device"] = "cpu"
    eng = mod.ServeEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                          chunk=chunk, sample=sample, seed=seed, spec=spec,
                          spec_k=spec_k, **kw)
    if wrong:
        eng.draft_src = _WrongDraft(cfg.vocab_size)
    if draft_params is not None and mod is serve:
        eng.draft_src.params = draft_params
    mod._warmup(eng, trace)
    done = []
    eng.start_clock()
    mod._drain(eng, sorted(trace, key=lambda r: r.arrival), 0, done)
    assert len(done) == len(trace)
    return eng, {r.rid: [int(t) for t in r.tokens] for r in trace}


def _books_balanced(eng):
    assert eng.paged
    assert (eng.pt_host == -1).all()
    assert (np.asarray(eng.alloc.ref) == 0).all()
    assert sorted(eng.alloc.free) == list(range(1, eng.n_pages))


def _counters(eng):
    return {k: getattr(eng, k) for k in SPEC_KEYS}


def _both(models, mk, *, sample=False, **kw):
    """The trace ``mk(module)`` through the JAX engine and the port's;
    asserts the margin, then the port's tokens and counters equal the JAX
    engine's.  Returns (port engine, JAX engine, tokens)."""
    cj, ct, pj, pt = models
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        eng_j, toks_j = _drive(jax_serve, cj, pj, mk(jax_serve),
                               sample=sample, **kw)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    trace = mk(serve)
    for r in trace:
        r.tokens = list(toks_j[r.rid])
    cache_len = kw.get("cache_len", 64)
    if sample:
        margin = serve.min_accept_margin(ct, pt, trace, cache_len,
                                         key=prng.key(kw.get("seed", 0)),
                                         device="cpu")
    else:
        margin = serve.min_accept_margin(ct, pt, trace, cache_len,
                                         device="cpu")
    assert margin >= 1e-3, f"a near tie along the tokens ({margin})"
    eng_t, toks_t = _drive(serve, ct, pt, mk(serve), sample=sample, **kw)
    assert toks_t == toks_j
    assert _counters(eng_t) == _counters(eng_j)
    assert eng_t.spec_rounds > 0
    return eng_t, eng_j, toks_t


def test_spec_engine_contiguous(models):
    # trace seed 5: the JAX test's seed 3 has a choice won by 8e-4 only
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=4, seed=5),
                      spec="ngram")
    assert not eng.paged


def test_spec_engine_ring_rotation_boundary():
    """A sliding-window model: spec_k 4 chunks of 20-token generations
    straddle the ring's rotation boundary again and again; a rejected tail
    needs no un-rotation, since verify never writes the ring."""
    models = _models(block_cycle=("attn_local",), sliding_window=8)
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=3, max_new=20),
                      spec="ngram", chunk=8)
    assert not eng.paged


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_spec_engine_paged_books(models, kv):
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=4 if kv == "f32"
                                               else 3, shared=32),
                      spec="ngram", cache_len=128, chunk=32, page_size=32,
                      prefix_cache=True, kv_dtype=kv)
    assert eng.paged and eng.kv_dtype_name == kv
    _books_balanced(eng)


def test_spec_engine_draft_model(models):
    """The draft-model source on the JAX draft's weights (its own are
    within 4 ulps of them, ``test_torch_spec_decode.py``): the same
    drafts, so the same acceptance."""
    cj, ct, _, _ = models
    dj = jax_serve.DraftModel(cj, 2, 64, 16, seed=0)
    dcfg = dataclasses.replace(torch_config("stablelm-1.6b").reduced(),
                               vocab_size=ct.vocab_size)
    dparams = TM.cast_params(dcfg, bridge.params_from_jax(
        dcfg, jax.tree.map(np.asarray, dj.params), device="cpu"))
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=3, max_new=10),
                      spec="draft", spec_k=3, draft_params=dparams)
    assert eng.draft_src.kind == "draft"


def test_spec_engine_sampled_streams(models):
    _both(models, lambda m: _trace(m, 512, n=4), spec="ngram", sample=True,
          seed=11)


@pytest.mark.parametrize("admission", ["optimistic", "reserve"])
def test_spec_engine_wrong_drafts_midpage(models, admission):
    """Always-wrong drafts on 8-row pages: rounds map pages that the
    accept decision then wholly rejects.  ``optimistic`` unmaps them (the
    rewind counter moves), ``reserve`` keeps them (it stays 0); the books
    balance either way."""
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=3, max_new=14),
                      spec="ngram", spec_k=6, page_size=8,
                      admission=admission, wrong=True)
    if admission == "optimistic":
        assert eng.spec_pages_rewound >= 1
    else:
        assert eng.spec_pages_rewound == 0
    assert eng.spec_drafts_accepted < eng.spec_drafted
    _books_balanced(eng)


def test_spec_engine_cow_fork_during_verify(models):
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=3, shared=32,
                                               duplicate=True),
                      spec="ngram", cache_len=128, chunk=32, page_size=32,
                      prefix_cache=True)
    assert eng.cow_events >= 1
    _books_balanced(eng)


def test_spec_engine_preemption_mid_speculation(models):
    # trace seed 4: the JAX test's seed 3 has a choice won by 4e-4 only
    eng, _, _ = _both(models, lambda m: _trace(m, 512, n=4,
                                               prompt_range=(10, 14),
                                               max_new=14, shared=8, seed=4),
                      spec="ngram", spec_k=6, n_slots=3, page_size=8,
                      n_pages=11, admission="optimistic")
    assert eng.preemptions >= 1
    _books_balanced(eng)


def test_spec_refused_with_decode_cp(models):
    _, ct, _, pt = models
    with pytest.raises(ValueError, match="queue 3"):
        serve.ServeEngine(ct, pt, n_slots=2, cache_len=64, device="cpu",
                          spec="ngram", decode_cp=True)
    with pytest.raises(ValueError, match="spec mode"):
        serve.ServeEngine(ct, pt, n_slots=2, cache_len=64, device="cpu",
                          spec="medusa")


def test_spec_cli(capsys):
    """``--spec`` through the CLI: the report's speculative block, the
    verify routes counted; lockstep refuses it."""
    import json
    serve.main(["--device", "cpu", "--greedy", "--spec", "ngram",
                "--requests", "4", "--cache-len", "128", "--page-size",
                "128"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = rec["speculative"]
    assert spec["spec"] == "ngram" and spec["rounds"] > 0 and rec["paged"]
    assert rec["verify_routes"]["verify_paged"] == \
        rec["verify_routes"]["flash_verify"] > 0
    with pytest.raises(SystemExit, match="engine"):
        serve.main(["--device", "cpu", "--mode", "lockstep", "--spec",
                    "ngram"])
