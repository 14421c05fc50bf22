"""The serve engine's token-loop admission of recurrent caches, against the
JAX engine on the CPU, and the engine's and CLIs' rules for such configs.

Reduced zamba2-1.2b (mamba2 with the shared attention block),
xlstm-1.3b (mLSTM) and xlstm with the ("mlstm", "slstm") cycle, with the
JAX package's parameters (bridged): ``run_engine`` and ``run_lockstep``
admit every request through ``ServeEngine._prefill_loop`` (one decode step
a prompt token on a single-row cache, written into the slot) and emit the
JAX engine's tokens, greedy and sampled (the prompt's last token drawn
from fold_in(fold_in(base_key, 2**31 + rid), i), the later ones from the
(rid, pos) streams).  Token identity is margin-qualified: every choice on
the trace wins by at least 1e-3 (for a sampled run over logits plus the
stream's Gumbel noise).  Then the rules the JAX engine keeps for such
configs, each against the JAX engine where it has one: contiguous by
default, no speculation, no recurrent draft model, int8 falling back to
f32 with the JAX warning, a warm-up without a prefill, decode_cp serving
zamba2's shared caches context-parallel; and the CLIs: the serve CLI
refuses whisper, the train CLI takes zamba2 and xlstm (the JAX CLI's first
loss) and fails on whisper's batches as the JAX CLI does.
"""
import dataclasses
import logging
import sys

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
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

# the JAX test's own trace for its fallback loop
# (tests/test_serve_engine.py::test_engine_fallback_loop_prefill)
TRACE = dict(prompt_range=(3, 6), gen_range=(2, 4), arrival_rate=0.0,
             seed=5)
ENGINE = dict(n_slots=2, cache_len=16, chunk=8, sample=False, seed=0)
# four requests on two slots: at trace seed 7 every greedy and sampled
# choice of the three models wins by >= 1e-3 (at seed 5 one xlstm-mixed
# choice wins by 8e-4, below the margin identity needs)
FOUR = dict(n=4, seed=7)
MIXED = dict(block_cycle=("mlstm", "slstm"))
CASES = {"zamba2": ("zamba2-1.2b", {}), "xlstm": ("xlstm-1.3b", {}),
         "xlstm-mixed": ("xlstm-1.3b", MIXED)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small ops, which intra-op threads only slow (several
    test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS = {}


def _models(case):
    if case not in _MODELS:
        arch, changes = CASES.get(case, (case, {}))
        cj = dataclasses.replace(jax_config(arch).reduced(), **changes)
        ct = dataclasses.replace(torch_config(arch).reduced(), **changes)
        pj = JM.init_params(cj, jax.random.key(0))
        pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                    device="cpu")
        _MODELS[case] = cj, ct, pj, pt
    return _MODELS[case]


def _traces(cfg, n=3, **over):
    kw = dict(TRACE, **over)
    return (jax_serve.gen_trace(n, vocab=cfg.vocab_size, **kw),
            serve.gen_trace(n, vocab=cfg.vocab_size, **kw))


def _jax_run(run, cj, pj, trace, **kw):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        return run(cj, pj, trace, **kw)
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _sampled_margin(cfg, params, trace, cache_len, seed=0):
    """The smallest top-2 gap of logits plus Gumbel noise along each
    request's sampled tokens, replayed on a single-row cache: the first
    token's noise from the token loop's key, fold_in(fold_in(fold_in(
    key(seed), 2**31 + rid), plen - 1), 0), the later ones' from the
    (rid, pos) streams.  0.0 when a token is not the replay's choice."""
    params = TM.cast_params(cfg, params)
    base = prng.key(seed)
    worst = float("inf")
    for r in trace:
        seq = [int(t) for t in r.prompt] + [int(t) for t in r.tokens]
        cache = TM.init_cache(cfg, 1, cache_len, dtype=torch.float32,
                              device="cpu")
        p0 = len(r.prompt)
        for i, t in enumerate(seq[:-1]):
            out, cache = TM.decode_step(cfg, params, cache,
                                        {"tokens": torch.tensor([[t]])},
                                        torch.tensor([i]))
            if i < p0 - 1:
                continue
            if i == p0 - 1:
                k = prng.fold_in(prng.fold_in(prng.fold_in(
                    base, 2 ** 31 + r.rid), i), 0)
            else:
                k = llm_a3c.stream_keys(base, r.rid, i + 1, 1)[0]
            row = out["logits"][0, -1].float()
            row = row + prng.gumbel(k, row.shape)
            top = torch.topk(row, 2)
            if int(top.indices[0]) != seq[i + 1]:
                return 0.0
            worst = min(worst, float(top.values[0].double()
                                     - top.values[1].double()))
    return worst


# ---------------------------------------------------------------------------
# the token loop against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_token_loop_engine_matches_jax_engine(case):
    """Greedy: the port engine's tokens are the JAX engine's, neither
    chunk-prefills nor pages, and every request completes."""
    cj, ct, pj, pt = _models(case)
    tj, tt = _traces(cj, **FOUR)
    rj = jax_serve.run_engine(cj, pj, tj, **ENGINE)
    rt = serve.run_engine(ct, pt, tt, device="cpu", **ENGINE)
    assert not rj["chunked_prefill"] and not rt["chunked_prefill"]
    assert not rj["paged"] and not rt["paged"]
    assert rt["requests"] == 4 and rt["logits_finite"]
    margin = serve.min_accept_margin(ct, pt, tt, ENGINE["cache_len"],
                                     device="cpu")
    assert margin >= 1e-3, margin
    assert [r.tokens for r in tt] == [r.tokens for r in tj]


@pytest.mark.parametrize("case", ["zamba2", "xlstm-mixed"])
def test_token_loop_sampled_tokens_match_jax_engine(case):
    """Sampled: the prompt's last token from the token loop's key (not the
    (rid, pos) stream of chunked admission), the rest from the streams;
    the JAX engine's tokens under its partitionable threefry layout."""
    cj, ct, pj, pt = _models(case)
    kw = dict(ENGINE, sample=True)
    tj, tt = _traces(cj, **FOUR)
    _jax_run(jax_serve.run_engine, cj, pj, tj, **kw)
    serve.run_engine(ct, pt, tt, device="cpu", **kw)
    margin = _sampled_margin(ct, pt, tt, kw["cache_len"])
    assert margin >= 1e-3, margin
    assert [r.tokens for r in tt] == [r.tokens for r in tj]


def test_token_loop_key_is_not_the_stream_key():
    """The first token's key, fold_in(base, 2**31 + rid) folded by i and by
    row 0, is not the (rid, plen) stream's key."""
    base = prng.key(0)
    loop = prng.fold_in(prng.fold_in(prng.fold_in(base, 2 ** 31 + 3), 4), 0)
    stream = llm_a3c.stream_keys(base, 3, 5, 1)[0]
    assert not torch.equal(loop, stream)
    want = jax.random.key_data(jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(jax.random.key(0), np.uint32(2 ** 31 + 3)), 4),
        0))
    np.testing.assert_array_equal(loop.numpy(), np.asarray(want))


def test_fallback_loop_prefill_trace_matches_jax():
    """The JAX test's own fallback trace (reduced xlstm, 3 requests, 2
    slots, cache 16), which the JAX test holds to sequential greedy
    decode: the port engine emits the JAX engine's tokens."""
    cj, ct, pj, pt = _models("xlstm")
    tj, tt = _traces(cj)
    rj = jax_serve.run_engine(cj, pj, tj, **ENGINE)
    rt = serve.run_engine(ct, pt, tt, device="cpu", **ENGINE)
    assert not rj["chunked_prefill"] and not rt["chunked_prefill"]
    assert serve.min_accept_margin(ct, pt, tt, 16, device="cpu") >= 1e-3
    assert [r.tokens for r in tt] == [r.tokens for r in tj]


@pytest.mark.parametrize("case", ["zamba2", "yi-6b"])
def test_lockstep_token_loop_matches_jax_lockstep(case):
    """``run_lockstep`` through the token loop: a recurrent config by
    default, an attention model with ``chunked_prefill=False`` (contiguous
    then, as the JAX runner forces)."""
    cj, ct, pj, pt = _models(case)
    tj, tt = _traces(cj, **FOUR)
    kw = {} if cj.name.startswith("zamba2") else dict(chunked_prefill=False)
    rj = jax_serve.run_lockstep(cj, pj, tj, **ENGINE, **kw)
    rt = serve.run_lockstep(ct, pt, tt, device="cpu", **ENGINE, **kw)
    assert not rj["chunked_prefill"] and not rt["chunked_prefill"]
    assert not rt["paged"] and rt["mode"] == "lockstep"
    assert serve.min_accept_margin(ct, pt, tt, 16, device="cpu") >= 1e-3
    assert [r.tokens for r in tt] == [r.tokens for r in tj]


def test_engine_without_chunked_prefill_is_the_token_loop():
    """``chunked_prefill=False`` is decided before the layout: no prefill
    step, no group cache, contiguous by default, and ``paged=True``
    refused (the token loop writes contiguous caches)."""
    _, ct, _, pt = _models("yi-6b")
    kw = dict(n_slots=2, cache_len=128, device="cpu", chunked_prefill=False)
    eng = serve.ServeEngine(ct, pt, **kw)
    assert eng.prefill_step is None and eng._group_cache is None
    assert not eng.paged
    with pytest.raises(ValueError, match="contiguous"):
        serve.ServeEngine(ct, pt, paged=True, **kw)


def test_write_rows_copies_every_state_leaf():
    """An admission writes the token loop's single row into its slot for
    every state leaf and every shared KV cache, and no other slot."""
    _, ct, _, pt = _models("zamba2")
    eng = serve.ServeEngine(ct, pt, device="cpu", **ENGINE)
    small = TM.init_cache(ct, 1, 16, dtype=torch.float32, device="cpu")
    for layer in TM.slot_layers(small):
        for name in TM.state_leaves(layer):
            layer[name].normal_()
    eng._write_rows(small, [(0, 1)])
    for big, one in zip(TM.slot_layers(eng.cache), TM.slot_layers(small)):
        for name in TM.state_leaves(big):
            assert torch.equal(big[name][1], one[name][0])
            assert not big[name][0].any()


# ---------------------------------------------------------------------------
# the engine's rules for recurrent configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_default_layout_is_contiguous(case):
    """``paged=None`` resolves to contiguous without a chunked prefill, as
    the JAX engine's rule (paged needs its prefill path); ``paged=True``
    has no attention layer to page."""
    cj, ct, pj, pt = _models(case)
    kw = dict(n_slots=2, cache_len=128)
    assert not jax_serve.ServeEngine(cj, pj, **kw).paged
    assert not serve.ServeEngine(ct, pt, device="cpu", **kw).paged
    with pytest.raises(ValueError, match="page"):
        serve.ServeEngine(ct, pt, device="cpu", paged=True, **kw)


@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_speculation_refused_as_jax(spec):
    cj, ct, pj, pt = _models("zamba2")
    kw = dict(n_slots=2, cache_len=16, spec=spec)
    with pytest.raises(ValueError, match="chunked-append"):
        jax_serve.ServeEngine(cj, pj, **kw)
    with pytest.raises(ValueError, match="chunked-append"):
        serve.ServeEngine(ct, pt, device="cpu", **kw)


def test_recurrent_draft_model_refused_as_jax():
    cj, ct, _, _ = _models("yi-6b")
    with pytest.raises(ValueError, match="chunked-prefill"):
        jax_serve.DraftModel(cj, 2, 16, 8, arch="xlstm-1.3b")
    with pytest.raises(ValueError, match="chunked-prefill"):
        serve.DraftModel(ct, 2, 16, 8, arch="xlstm-1.3b", device="cpu")


@pytest.mark.parametrize("case", ["zamba2", "xlstm"])
def test_int8_falls_back_to_f32_with_the_jax_warning(case, caplog):
    """No layer kind is attention (zamba2's shared block is not a layer
    kind), so int8 falls back to f32 storage with the JAX engine's
    warning, and the tokens are the f32 engine's."""
    cj, ct, pj, pt = _models(case)
    with caplog.at_level(logging.WARNING):
        want = jax_serve.ServeEngine(cj, pj, n_slots=2, cache_len=16,
                                     kv_dtype="int8")
    jax_msgs = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        eng = serve.ServeEngine(ct, pt, n_slots=2, cache_len=16,
                                kv_dtype="int8", device="cpu")
    msgs = [r.getMessage() for r in caplog.records]
    assert eng.kv_dtype_name == want.kv_dtype_name == "f32"
    assert msgs and msgs == [m for m in jax_msgs if "int8" in m]
    for layer in TM.slot_layers(eng.cache):
        assert all(layer[n].dtype == torch.float32
                   for n in TM.state_leaves(layer))
    t8, tf = _traces(ct)[1], _traces(ct)[1]
    serve.run_engine(ct, pt, t8, device="cpu", kv_dtype="int8", **ENGINE)
    serve.run_engine(ct, pt, tf, device="cpu", **ENGINE)
    assert [r.tokens for r in t8] == [r.tokens for r in tf]


def test_warmup_runs_no_prefill(monkeypatch):
    """The warm-up admits its request through the token loop: no chunked
    prefill is ever called, and it leaves a fresh engine's books."""
    _, ct, _, pt = _models("xlstm")

    def refuse(*a, **k):
        raise AssertionError("chunked prefill called")
    monkeypatch.setattr(TM, "prefill_step", refuse)
    eng = serve.ServeEngine(ct, pt, device="cpu", **ENGINE)
    assert eng.prefill_step is None and eng._group_cache is None
    trace = _traces(ct)[1]
    serve._warmup(eng, trace)
    assert eng.step_count == 0 and eng.prefill_tokens == 0


def test_decode_cp_serves_the_shared_caches_context_parallel():
    """The JAX CLI serves a recurrent config under ``--decode-cp``: its
    attention caches (zamba2's shared block) split along the sequence,
    the recurrent states whole.  Over a one-rank gloo group the port's
    engine reports ``decode_cp[1]``, attends the shared caches through
    the partials path, and emits the tokens of the engine without it."""
    _, ct, _, pt = _models("zamba2")
    t_cp, t_plain = _traces(ct, **FOUR)[1], _traces(ct, **FOUR)[1]
    from repro_torch.kernels import dispatch
    with sharding.process_group(torch.device("cpu")):
        calls = []
        partials = dispatch.decode_attention
        wrapped = (lambda *a, **k: calls.append(k.get("cp")) or
                   partials(*a, **k))
        dispatch.decode_attention = wrapped
        try:
            rep = serve.run_engine(ct, pt, t_cp, device="cpu",
                                   decode_cp=True, **ENGINE)
        finally:
            dispatch.decode_attention = partials
    serve.run_engine(ct, pt, t_plain, device="cpu", **ENGINE)
    assert rep["decode_layout"] == "decode_cp[1]"
    assert any(c is not None for c in calls)
    assert [r.tokens for r in t_cp] == [r.tokens for r in t_plain]


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_refuses_whisper_as_the_jax_cli(monkeypatch):
    from repro.launch import serve as js
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-base",
                                      "--reduced"])
    with pytest.raises(SystemExit) as want:
        js.main()
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_train_cli_first_loss_matches_jax_cli(arch, capsys, monkeypatch):
    """``--mode llm --arch <arch> --reduced --device cpu``: the port draws
    the JAX CLI's weights and batches, so its first loss is the JAX CLI's
    within 1e-5 relative."""
    import json

    from repro.launch import train as jax_train
    from repro_torch.launch import train as torch_train
    argv = ["--mode", "llm", "--arch", arch, "--reduced", "--steps", "1",
            "--seq", "32", "--batch", "2", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        jax_train.main()
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    want = json.loads(capsys.readouterr().out.splitlines()[0])["loss"]
    got = torch_train.main(argv + ["--device", "cpu"])["history"][0]["loss"]
    capsys.readouterr()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_train_cli_fails_on_whisper_as_the_jax_cli(monkeypatch):
    """The token pipeline gives no ``enc_frames``: both CLIs fail on the
    first batch with a KeyError that names it."""
    from repro.launch import train as jax_train
    from repro_torch.launch import train as torch_train
    argv = ["--mode", "llm", "--arch", "whisper-base", "--reduced",
            "--steps", "1", "--seq", "16", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(KeyError, match="enc_frames"):
        jax_train.main()
    with pytest.raises(KeyError, match="enc_frames"):
        torch_train.main(argv + ["--device", "cpu"])
