"""The port's serve engine against the JAX engine on the CPU.

Reduced yi-6b with the JAX package's parameters (bridged), greedy decoding,
the same ``gen_trace``: the port's ``run_engine`` and ``run_lockstep`` emit
the same tokens as the JAX engine on its contiguous layout
(``paged=False``).  Token identity across frameworks holds up to the
argmax margin: the test first checks with ``serve.min_accept_margin`` that
every greedy choice on the trace wins by at least 1e-3, far above the
~1e-6 by which XLA and PyTorch sums differ.
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
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TRACE = dict(prompt_range=(3, 20), gen_range=(1, 8), arrival_rate=0.0,
             seed=3)
ENGINE = dict(n_slots=2, cache_len=32, chunk=8, sample=False, seed=0)


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


def test_sampling_is_keyed_by_stream_and_position():
    """A draw depends only on (seed, stream id, position): not on the
    row's slot, the batch size or its neighbours."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    sids = torch.tensor([7, 3, 11, 0, 9])
    pos = torch.tensor([4, 40, 4, 1, 17])
    tok = llm_a3c.sample_slot_tokens(logits, 5, sids=sids, pos=pos)
    perm = torch.tensor([3, 0, 4, 2, 1])
    tok_p = llm_a3c.sample_slot_tokens(logits[perm], 5, sids=sids[perm],
                                       pos=pos[perm])
    assert torch.equal(tok_p, tok[perm])
    for j in range(5):
        one = llm_a3c.sample_slot_tokens(logits[j:j + 1], 5,
                                         sids=sids[j:j + 1],
                                         pos=pos[j:j + 1])
        assert int(one[0]) == int(tok[j])
    greedy = llm_a3c.sample_slot_tokens(logits, 5, sample=False)
    assert torch.equal(greedy, logits.argmax(-1))


def test_sampling_follows_the_softmax():
    """Gumbel-max over the counter-hash noise draws from softmax(logits)."""
    p = np.array([0.5, 0.3, 0.2])
    n = 6000
    logits = torch.from_numpy(np.log(np.tile(p, (n, 1))).astype(np.float32))
    tok = llm_a3c.sample_slot_tokens(logits, 1, sids=torch.zeros(n),
                                     pos=torch.arange(n))
    freq = np.bincount(tok.numpy(), minlength=3) / n
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_engine_refuses_later_slices(models):
    _, ct, _, pt = models
    kw = dict(n_slots=2, cache_len=16, device="cpu")
    for bad in (dict(paged=True), dict(spec="ngram"),
                dict(fault_plan=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve.ServeEngine(ct, pt, **kw, **bad)
    trace = serve.gen_trace(2, vocab=ct.vocab_size, **TRACE)
    trace[0].deadline_ttft = 1.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.run_engine(ct, pt, trace, **ENGINE, device="cpu")


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
        "flash_append_int8": 0, "decode_attention": 0,
        "decode_attention_int8": 0, "decode_attention_partials": 0,
        "decode_attention_partials_int8": 0, "flash_attention": 0,
        "flash_attention_f32": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_f32": 0, "rmsprop": 0}


def test_prefill_step_matches_model(models):
    _, ct, _, pt = models
    step = llm_a3c.make_prefill_step(ct)
    cache = TM.init_cache(ct, 1, 16, dtype=torch.float32, device="cpu")
    toks = torch.arange(8)[None]
    logits, _ = step(pt, cache, {"tokens": toks})
    cache2 = TM.init_cache(ct, 1, 16, dtype=torch.float32, device="cpu")
    out, _ = TM.prefill_step(ct, pt, cache2, {"tokens": toks})
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits, out["logits"].float())
