"""The port's serve engine against the JAX engine on the CPU.

Reduced yi-6b with the JAX package's parameters (bridged), the same
``gen_trace``: the port's ``run_engine`` and ``run_lockstep`` emit the same
greedy tokens as the JAX engine on its contiguous layout (``paged=False``),
and the same sampled tokens on one seed (``repro_torch.core.prng`` is
jax.random's threefry; jax's partitionable layout, the port's default, is
set for the JAX engine).  Token identity across frameworks holds up to the
argmax margin: the test first checks with ``min_accept_margin`` that every
choice on the trace wins by at least 1e-3 (for a sampled run, over logits
plus the stream's Gumbel noise), far above the ~1e-6 by which XLA and
PyTorch sums differ.
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
from repro_torch.core import llm_a3c, prng  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TRACE = dict(prompt_range=(3, 20), gen_range=(1, 8), arrival_rate=0.0,
             seed=3)
ENGINE = dict(n_slots=2, cache_len=32, chunk=8, sample=False, seed=0)
SAMPLED = dict(ENGINE, sample=True)
PAGE = 8                  # pages a 32-row cache: the paged twins' layout


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


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Greedy tokens of the JAX engine (contiguous layout) per request."""
    cj, _, pj, _ = models
    trace = jax_serve.gen_trace(6, vocab=cj.vocab_size, **TRACE)
    jax_serve.run_engine(cj, pj, trace, paged=False, **ENGINE)
    margin = jax_serve.min_accept_margin(cj, pj, trace, ENGINE["cache_len"])
    return {r.rid: list(r.tokens) for r in trace}, margin


@pytest.fixture(scope="module")
def jax_sampled_tokens(models):
    """Sampled tokens of the JAX engine (contiguous layout) per request,
    under jax's partitionable threefry layout."""
    cj, _, pj, _ = models
    trace = jax_serve.gen_trace(6, vocab=cj.vocab_size, **TRACE)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        jax_serve.run_engine(cj, pj, trace, paged=False, **SAMPLED)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return trace


@pytest.fixture(scope="module")
def jax_paged_runs(models):
    """The paged twins of ``jax_tokens`` and ``jax_sampled_tokens``: the
    JAX engine's default layout, which pages a 32-row cache at page 8."""
    cj, _, pj, _ = models
    out = {}
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        for kw in (ENGINE, SAMPLED):
            trace = jax_serve.gen_trace(6, vocab=cj.vocab_size, **TRACE)
            rep = jax_serve.run_engine(cj, pj, trace, page_size=PAGE, **kw)
            assert rep["paged"]
            out[kw["sample"]] = ({r.rid: list(r.tokens) for r in trace}, rep)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return out


def test_gen_trace_matches_jax():
    for kw in (TRACE, dict(prompt_range=(1, 40), gen_range=(2, 9),
                           arrival_rate=5.0, seed=11)):
        a = jax_serve.gen_trace(7, vocab=100, **kw)
        b = serve.gen_trace(7, vocab=100, **kw)
        for x, y in zip(a, b):
            assert (x.rid, x.max_new, x.arrival) == (y.rid, y.max_new,
                                                     y.arrival)
            np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("pmax,chunk,cache_len", [(1, 8, 32), (17, 8, 32),
                                                  (30, 8, 32), (5, 64, 32),
                                                  (32, 16, 32)])
def test_chunk_grid_and_padding_match_jax(pmax, chunk, cache_len):
    assert serve._chunk_grid(pmax, chunk, cache_len) == \
        jax_serve._chunk_grid(pmax, chunk, cache_len)
    prompts = [np.arange(pmax, dtype=np.int32), np.arange(3, dtype=np.int32)]
    ta, pa, ga = serve._pad_group(prompts, 3, chunk, cache_len)
    tb, pb, gb = jax_serve._pad_group(prompts, 3, chunk, cache_len)
    np.testing.assert_array_equal(ta, tb)
    assert (pa, ga) == (pb, gb)


def test_engine_tokens_match_jax_engine(models, jax_tokens):
    want, margin = jax_tokens
    assert margin >= 1e-3, f"trace has a near-tie greedy choice ({margin})"
    _, ct, _, pt = models
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    rep = serve.run_engine(ct, pt, trace, device="cpu", **ENGINE)
    assert rep["requests"] == len(trace) and rep["logits_finite"]
    assert {r.rid: r.tokens for r in trace} == want
    assert all(len(r.tokens) == r.max_new for r in trace)


def test_lockstep_tokens_match_jax_engine(models, jax_tokens):
    want, _ = jax_tokens
    _, ct, _, pt = models
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    rep = serve.run_lockstep(ct, pt, trace, device="cpu", **ENGINE)
    assert rep["mode"] == "lockstep" and rep["requests"] == len(trace)
    assert {r.rid: r.tokens for r in trace} == want


def test_engine_sampled_tokens_match_jax_engine(models, jax_sampled_tokens):
    trace_j = jax_sampled_tokens
    _, ct, _, pt = models
    margin = serve.min_accept_margin(ct, pt, trace_j, SAMPLED["cache_len"],
                                     key=prng.key(SAMPLED["seed"]),
                                     device="cpu")
    assert margin >= 1e-3, f"trace has a near-tie sampled choice ({margin})"
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    rep = serve.run_engine(ct, pt, trace, device="cpu", **SAMPLED)
    assert rep["requests"] == len(trace) and rep["logits_finite"]
    assert {r.rid: r.tokens for r in trace} == \
        {r.rid: list(r.tokens) for r in trace_j}
    # sampling changed the tokens: the run is not the greedy one
    greedy = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    serve.run_engine(ct, pt, greedy, device="cpu", **ENGINE)
    assert [r.tokens for r in greedy] != [r.tokens for r in trace]


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_paged_engine_tokens_match_jax_paged_engine(models, jax_tokens,
                                                    jax_sampled_tokens,
                                                    jax_paged_runs, sample):
    """The paged twin of the two parity tests above: both engines on their
    default layout, which pages this cache; the same tokens as the
    contiguous runs, and the JAX engine's page counters."""
    want, rep_j = jax_paged_runs[sample]
    contiguous = {r.rid: list(r.tokens) for r in jax_sampled_tokens} \
        if sample else jax_tokens[0]
    assert want == contiguous
    _, ct, _, pt = models
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    rep = serve.run_engine(ct, pt, trace, device="cpu", page_size=PAGE,
                           **(SAMPLED if sample else ENGINE))
    assert rep["paged"] and rep["logits_finite"]
    assert {r.rid: r.tokens for r in trace} == want
    for k in ("n_pages", "pages_requested", "pages_alloced", "cow_events",
              "prefill_chunks_skipped", "dedup_ratio", "pool_high_water"):
        assert rep[k] == rep_j[k], k


def test_paged_lockstep_tokens_match_jax_engine(models, jax_tokens):
    want, _ = jax_tokens
    _, ct, _, pt = models
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    rep = serve.run_lockstep(ct, pt, trace, device="cpu", page_size=PAGE,
                             **ENGINE)
    assert rep["mode"] == "lockstep" and rep["paged"]
    assert {r.rid: r.tokens for r in trace} == want


def test_min_accept_margin_matches_jax(models, jax_tokens):
    """The port's margin of a greedy run is the reference's, up to the
    ~1e-6 by which the two frameworks' logits differ."""
    want, margin_j = jax_tokens
    cj, ct, _, pt = models
    trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
    for r in trace:
        r.tokens = list(want[r.rid])
    margin = serve.min_accept_margin(ct, pt, trace, ENGINE["cache_len"],
                                     device="cpu")
    assert abs(margin - margin_j) < 1e-4
    trace[0].tokens[-1] = (trace[0].tokens[-1] + 1) % ct.vocab_size
    assert serve.min_accept_margin(ct, pt, trace, ENGINE["cache_len"],
                                   device="cpu") == 0.0


def test_sampling_is_keyed_by_stream_and_position():
    """A draw depends only on (key, stream id, position): not on the
    row's slot, the batch size or its neighbours."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    sids = torch.tensor([7, 3, 11, 0, 9])
    pos = torch.tensor([4, 40, 4, 1, 17])
    key = prng.key(5)
    tok = llm_a3c.sample_slot_tokens(logits, key, sids=sids, pos=pos)
    perm = torch.tensor([3, 0, 4, 2, 1])
    tok_p = llm_a3c.sample_slot_tokens(logits[perm], key, sids=sids[perm],
                                       pos=pos[perm])
    assert torch.equal(tok_p, tok[perm])
    for j in range(5):
        one = llm_a3c.sample_slot_tokens(logits[j:j + 1], key,
                                         sids=sids[j:j + 1],
                                         pos=pos[j:j + 1])
        assert int(one[0]) == int(tok[j])
    greedy = llm_a3c.sample_slot_tokens(logits, key, sample=False)
    assert torch.equal(greedy, logits.argmax(-1))


def test_sampling_follows_the_softmax():
    """Gumbel-max over the threefry noise draws from softmax(logits)."""
    p = np.array([0.5, 0.3, 0.2])
    n = 6000
    logits = torch.from_numpy(np.log(np.tile(p, (n, 1))).astype(np.float32))
    tok = llm_a3c.sample_slot_tokens(logits, prng.key(1),
                                     sids=torch.zeros(n),
                                     pos=torch.arange(n))
    freq = np.bincount(tok.numpy(), minlength=3) / n
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_engine_refuses_later_slices(models):
    """Nothing of the earlier slices is refused any more: recurrent caches
    (mamba2 with zamba2's shared attention, mLSTM/sLSTM) build and admit
    through the token loop (their parity with the JAX engine is in
    ``test_torch_recurrent_engine.py``), MoE models serve
    (``test_torch_moe_engine.py``), and so do speculative decoding
    (``test_torch_spec_engine.py``), the paged layout, fault plans and
    deadlines (``test_torch_paged_kv.py``,
    ``test_torch_serve_robustness.py`` and the paged twins below).  Only
    the serve CLI refuses encoder-decoder and VLM configs, as the JAX
    CLI."""
    _, ct, _, pt = models
    kw = dict(n_slots=2, cache_len=16, device="cpu")
    for spec in ("ngram", "draft"):
        assert serve.ServeEngine(ct, pt, spec=spec, **kw).spec == spec
    zc = torch_config("zamba2-1.2b").reduced()
    zp = TM.init_params(zc, 0, "cpu")
    eng = serve.ServeEngine(zc, zp, **kw)
    assert eng.prefill_step is None and not eng.paged
    rep = serve.run_engine(zc, zp, serve.gen_trace(
        2, vocab=zc.vocab_size, **TRACE), **ENGINE, device="cpu")
    assert rep["requests"] == 2 and not rep["chunked_prefill"]
    eng = serve.ServeEngine(ct, pt, paged=True, page_size=8,
                            fault_plan=serve.FaultPlan(hold_pages=1), **kw)
    assert eng.paged and eng.usable_pages == 2 * 2 - 1
    trace = serve.gen_trace(2, vocab=ct.vocab_size, **TRACE)
    trace[0].deadline_ttft = 1.0
    rep = serve.run_engine(ct, pt, trace, **ENGINE, device="cpu")
    assert rep["requests"] == 2 and not rep["paged"]


def test_validate_trace_rejects_cache_overrun():
    trace = serve.gen_trace(1, vocab=10, prompt_range=(20, 20),
                            gen_range=(20, 20), arrival_rate=0.0, seed=0)
    with pytest.raises(ValueError, match="cache_len"):
        serve._validate_trace(trace, 32)


def test_cli_runs_on_cpu(capsys):
    assert serve.build_parser().parse_args(["--no-reduced"]).reduced is False
    serve.main(["--device", "cpu", "--requests", "3", "--greedy",
                "--prompt-range", "4,12", "--gen-range", "2,5"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["requests"] == 3 and rec["device"] == "cpu"
    assert rec["kernel_launches"] == {
        "rmsnorm": 0, "rmsnorm_bwd": 0, "flash_append": 0,
        "flash_append_f32": 0, "flash_append_int8": 0,
        "flash_append_int8_f32": 0, "decode_attention": 0,
        "decode_attention_int8": 0, "decode_attention_partials": 0,
        "decode_attention_partials_int8": 0, "flash_attention": 0,
        "flash_attention_f32": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_f32": 0, "flash_attention_offset": 0,
        "flash_attention_offset_f32": 0, "flash_attention_bwd_offset": 0,
        "flash_attention_bwd_offset_f32": 0, "rmsprop": 0,
        "rmsprop_update_multi": 0, "rmsprop_apply_multi": 0}


def test_prefill_step_matches_model(models):
    _, ct, _, pt = models
    step = llm_a3c.make_prefill_step(ct)
    cache = TM.init_cache(ct, 1, 16, dtype=torch.float32, device="cpu")
    toks = torch.arange(8)[None]
    logits, _ = step(pt, cache, {"tokens": toks})
    cache2 = TM.init_cache(ct, 1, 16, dtype=torch.float32, device="cpu")
    out, _ = TM.prefill_step(ct, pt, cache2, {"tokens": toks})
    assert logits.dtype == out["logits"].dtype
    torch.testing.assert_close(logits, out["logits"])


@pytest.mark.parametrize("seed", (0, 3))
def test_slot_sampling_matches_jax(seed):
    """``sample_slot_tokens`` against the reference's on the same logits
    and key: the engine's (sid, pos) streams and the per-row fold."""
    from repro.core import llm_a3c as jax_a3c
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((4, 512)) * 2).astype(np.float32)
    sids = np.array([0, 5, 2, 9], np.int32)
    pos = np.array([3, 17, 30, 1], np.int32)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        kj = jax.random.key(seed)
        want = np.asarray(jax_a3c.sample_slot_tokens(logits, kj, sids=sids,
                                                     pos=pos))
        want_rows = np.asarray(jax_a3c.sample_slot_tokens(logits, kj))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    lt = torch.from_numpy(logits)
    got = llm_a3c.sample_slot_tokens(lt, prng.key(seed),
                                     sids=torch.from_numpy(sids),
                                     pos=torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        llm_a3c.sample_slot_tokens(lt, prng.key(seed)).numpy(), want_rows)
