"""The port's context-parallel decode against the JAX package on the CPU.

Kernel 7 (``decode_attention_partials``): the plain version and the
wrapper (CPU tensors) against the Pallas kernel in interpret mode, f32 and
int8, with ragged per-slot positions and a fully masked slice, acc, m and
l to rtol = atol = 1e-5 (f32 sums in another order).  ``combine_partials``
over 2 and 4 slices against ``repro.kernels.ref``'s decode oracles (1e-5).
The layout pieces: the rank-owned cache write, the divisibility rule, the
combine's byte count.

Two ranks: ``torch.multiprocessing.spawn`` starts a gloo group over a
``file://`` store.  Reduced Yi-6B ``decode_step`` logits under
``decode_cp[2]`` match JAX's unruled ``M.decode_step`` to 2e-4 (the f32
cache), and ``run_engine(decode_cp=True, paged=False)`` emits the JAX
engine's greedy tokens at f32 and int8 KV on both ranks.  Token identity
across frameworks holds up to the argmax margin: each trace's greedy
choices must win by far more than the frameworks' logit noise, about 1e-6
with an f32 cache and up to about 2e-3 with an int8 one (a quantised value
on a rounding boundary can move by one step).
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import kv_quant as jax_kvq  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import traffic as jax_traffic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.distributed import ctx, sharding  # noqa: E402
from repro_torch.kernels import (decode_attention_cuda, kv_quant,  # noqa: E402
                                 ref)
from repro_torch.launch import serve, traffic  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, HQ, HKV, D, L = 3, 8, 2, 64, 256


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _inputs(quant: bool, seed: int = 0):
    """q (B,Hq,D), caches (B,L,Hkv,D) (int8 + scales when ``quant``), kpos
    (B,L), pos (B,): row 0 at pos 100, row 1 at the last slot, row 2 an
    idle slot whose kpos is all -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    pos = np.array([100, L - 1, 7], np.int32)
    kpos = np.where(np.arange(L)[None] <= pos[:, None], np.arange(L)[None],
                    -1).astype(np.int32)
    kpos[2] = -1
    scales = (None, None)
    if quant:
        (k, ks), (v, vs) = (jax_kvq.quantize(jnp.asarray(x)) for x in (k, v))
        k, v = np.array(k), np.array(v)
        scales = (np.array(ks), np.array(vs))
    return q, k, v, kpos, pos, scales


def _slices(n):
    step = L // n
    return [slice(i * step, (i + 1) * step) for i in range(n)]


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# kernel 7 and the combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("part", [0, 1], ids=["live_slice", "masked_slice"])
def test_partials_match_pallas(quant, part):
    """The second half of the cache holds no valid key of row 0 (pos 100)
    nor of the idle row 2: those rows keep m = NEG, l = 128 and acc = the
    sum of their v rows there, as the TPU kernel does."""
    q, k, v, kpos, pos, (ks, vs) = _inputs(quant)
    s = _slices(2)[part]
    sl = [None if a is None else a[:, s] for a in (k, v, kpos, ks, vs)]
    want = jax_decode.decode_attention_partials(
        *(jnp.asarray(a) for a in (q, sl[0], sl[1], sl[2], pos)),
        block_k=64, interpret=True,
        k_scale=None if ks is None else jnp.asarray(sl[3]),
        v_scale=None if vs is None else jnp.asarray(sl[4]))
    qt, kt, vt, kpt, post, kst, vst = _torch(q, *sl[:3], pos, *sl[3:])
    for got in (ref.decode_attention_partials_ref(qt, kt, vt, kpt, post,
                                                  kst, vst),
                decode_attention_cuda.decode_attention_partials(
                    qt, kt, vt, kpt, post, kst, vst)):
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            _close(g, w)
    if part == 1:
        acc, m, l = want
        assert np.all(np.asarray(m)[[0, 2]] == ref.NEG)
        assert np.all(np.asarray(l)[[0, 2]] == L // 2)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_combine_partials_matches_reference(quant, n):
    """Partials of n disjoint slices, combined, equal one decode over the
    whole cache: slices without a valid key vanish, and the idle row keeps
    the finite mean of v."""
    q, k, v, kpos, pos, (ks, vs) = _inputs(quant, seed=n)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    if quant:
        want = jax_ref.decode_attention_quant_ref(
            *jq, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(kpos),
            jnp.asarray(pos))
    else:
        want = jax_ref.decode_attention_ref(*jq, jnp.asarray(kpos),
                                            jnp.asarray(pos))
    qt, post = _torch(q, pos)
    parts = []
    for s in _slices(n):
        kt, vt, kpt, kst, vst = _torch(
            k[:, s], v[:, s], kpos[:, s], None if ks is None else ks[:, s],
            None if vs is None else vs[:, s])
        parts.append(decode_attention_cuda.decode_attention_partials(
            qt, kt, vt, kpt, post, kst, vst))
    got = ref.combine_partials(parts)
    _close(got, want)
    idle = v[2].astype(np.float32) if not quant else \
        np.asarray(jax_kvq.dequantize(jnp.asarray(v[2]), jnp.asarray(vs[2])))
    _close(got[2].reshape(HKV, HQ // HKV, D),
           idle.mean(0)[:, None, :].repeat(HQ // HKV, 1))


# ---------------------------------------------------------------------------
# layout: the rank-owned write, the rule, the combine's bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_cp_write_lands_on_the_owning_rank(n):
    """Each rank writes a row only where its slice owns the slot: the
    slices, put side by side, equal one whole-cache write (int8 payload
    and its scales alike)."""
    rng = np.random.default_rng(n)
    length, b = 32, 4
    whole = attn.init_kv_cache(b, length, HKV, 16, torch.int8)
    l_loc = length // n
    parts = [attn.init_kv_cache(b, l_loc, HKV, 16, torch.int8)
             for _ in range(n)]
    slot = torch.tensor([0, l_loc - 1, l_loc, length - 1])
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((b, 1, HKV, 16))
                             .astype(np.float32))
        new = dict(zip(("k", "ks"), kv_quant.quantize(x)))
        new.update(zip(("v", "vs"), kv_quant.quantize(-x)))
        rows = torch.arange(b)
        for name, t in new.items():
            whole[name][rows, slot] = t[:, 0]
        for r, part in enumerate(parts):
            attn._update_kv_cache_cp(
                part, new, slot, sharding.DecodeCPSpec(None, r, n, l_loc))
        slot = (slot + 1) % length
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(torch.cat([p[name] for p in parts], dim=1),
                           whole[name])


def test_cp_rule_needs_divisibility_only():
    rule = {"group": None, "rank": 1, "n_shards": 4}
    spec, why = sharding.decode_cp_shard_spec(rule, length=96)
    assert why == "" and spec == sharding.DecodeCPSpec(None, 1, 4, 24)
    assert spec.start == 24        # no 128-row alignment rule
    spec, why = sharding.decode_cp_shard_spec(rule, length=90)
    assert spec is None and "does not divide" in why
    with ctx.sharding_rules({"decode_cp": rule}):
        assert attn._decode_cp_rule(96) is rule
        assert attn._decode_cp_rule(90) is None
        sliced = attn.init_kv_cache(2, 96, HKV, 16, torch.bfloat16)
        whole = attn.init_kv_cache(2, 90, HKV, 16, torch.bfloat16)
    assert sliced["k"].shape[1] == 24 and sliced["global_len"] == 96
    assert whole["k"].shape[1] == 90 and "global_len" not in whole
    assert ctx.current_rules() is None


def test_cp_slice_outside_its_rules_raises():
    """A cache slice attended alone would see a quarter of the keys."""
    cfg = torch_config("yi-6b").reduced()
    params = TM.init_params(cfg, 0, "cpu")
    rule = {"group": None, "rank": 0, "n_shards": 4}
    with ctx.sharding_rules({"decode_cp": rule}):
        cache = TM.init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="outside the decode_cp rules"):
        TM.decode_step(cfg, params, cache,
                       {"tokens": torch.zeros(1, 1, dtype=torch.long)},
                       torch.tensor([3]))
    with pytest.raises(ValueError, match="whole caches"):
        with ctx.sharding_rules({"decode_cp": rule}):
            TM.prefill_step(cfg, params, cache,
                            {"tokens": torch.zeros(1, 4, dtype=torch.long)})


@pytest.mark.parametrize("arch,batch,n", [("yi-6b", 4, 1), ("yi-6b", 8, 4),
                                          ("stablelm-1.6b", 2, 2)])
def test_combine_bytes_match_jax(arch, batch, n):
    assert traffic.decode_cp_combine_bytes(torch_config(arch), batch, n) == \
        jax_traffic.decode_cp_combine_bytes(jax_config(arch), batch, n)


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------

# the serve tests' trace shape; seed 5 is a draw whose greedy margins clear
# both bounds (asserted below, so a near-tie fails loudly, never by luck)
TRACE = dict(prompt_range=(3, 20), gen_range=(1, 8), arrival_rate=0.0,
             seed=5)
ENGINE = dict(n_slots=2, cache_len=32, chunk=8, sample=False, seed=0)
STEP_POS0 = np.array([12, 14], np.int32)   # decode crosses slot 16 (rank 1)
N_STEPS = 6


def _step_inputs(vocab):
    rng = np.random.default_rng(21)
    toks = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    nxt = rng.integers(0, vocab, (N_STEPS, 2, 1)).astype(np.int32)
    return toks, nxt


def _cp_logits(ct, pt, kv_dtype, rank):
    """Prefill on a whole cache, copy this rank's columns into a cache
    laid out under decode_rules, then N_STEPS decode steps under them."""
    toks, nxt = _step_inputs(ct.vocab_size)
    whole = TM.init_cache(ct, 2, ENGINE["cache_len"], dtype=kv_dtype,
                          device="cpu")
    TM.prefill_step(ct, pt, whole, {"tokens": torch.from_numpy(toks)}, 0,
                    torch.from_numpy(STEP_POS0))
    from repro_torch.launch import mesh as mesh_mod
    rules = sharding.decode_rules(
        ct, mesh_mod.make_mesh((1, dist.get_world_size()), "cpu"),
        batch_size=2)
    out = []
    with ctx.sharding_rules(rules):
        cache = TM.init_cache(ct, 2, ENGINE["cache_len"], dtype=kv_dtype,
                              device="cpu")
        for big, small in zip(cache["layers"], whole["layers"]):
            l_loc = big["k"].shape[1]
            for name in attn.kv_leaves(big):
                big[name].copy_(small[name][:, rank * l_loc:
                                            (rank + 1) * l_loc])
        pos = torch.from_numpy(STEP_POS0)
        for step in range(N_STEPS):
            o, cache = TM.decode_step(ct, pt, cache,
                                      {"tokens": torch.from_numpy(nxt[step])},
                                      pos)
            out.append(o["logits"][:, -1].numpy())
            pos = pos + 1
    return np.stack(out)


def _rank_main(rank, world, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world)
    try:
        ct = torch_config("yi-6b").reduced()
        with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
            pt = bridge.params_from_jax(ct, pickle.load(f), device="cpu")
        out = {"logits_f32": _cp_logits(ct, pt, torch.float32, rank)}
        for label, kv, cache_len in (("f32", "f32", 32),
                                     ("int8", "int8", 32),
                                     ("f32_odd", "f32", 33)):
            trace = serve.gen_trace(6, vocab=ct.vocab_size, **TRACE)
            rep = serve.run_engine(ct, pt, trace, device="cpu",
                                   decode_cp=True, paged=False, kv_dtype=kv,
                                   **dict(ENGINE, cache_len=cache_len))
            out[label] = (rep, {r.rid: list(r.tokens) for r in trace})
        try:
            sharding.check_backend(None, torch.device("cuda"))
        except ValueError as e:
            out["mismatch"] = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _int8_margin(cj, pj, trace, cache_len):
    """``serve.min_accept_margin`` over an int8 cache: the smallest top-2
    logit gap along each request's greedy stream, decoded one slot at a
    time."""
    step = jax.jit(lambda c, t, p: JM.decode_step(cj, pj, c, {"tokens": t},
                                                  p))
    worst = float("inf")
    for r in trace:
        seq = [int(t) for t in r.prompt] + [int(t) for t in r.tokens]
        cache = JM.init_cache(cj, 1, cache_len, dtype=jnp.float32,
                              kv_dtype=jnp.int8)
        for i, t in enumerate(seq[:-1]):
            out, cache = step(cache, jnp.asarray([[t]], jnp.int32),
                              jnp.asarray(i))
            if i >= len(r.prompt) - 1:
                row = np.asarray(out["logits"][0, -1], np.float64)
                top2 = np.sort(row)[-2:]
                if int(row.argmax()) != seq[i + 1]:
                    return 0.0
                worst = min(worst, float(top2[1] - top2[0]))
    return worst


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks, started (not joined) on reduced Yi-6B's JAX
    parameters; they run while the JAX references are computed."""
    cj = jax_config("yi-6b").reduced()
    pj = JM.init_params(cj, jax.random.key(0))
    tmp = tmp_path_factory.mktemp("cp2")
    # the parameters go through a file: a large argument would hold the
    # spawn until each child has imported this module
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, pj), f)
    procs = mp.spawn(_rank_main, args=(2, str(tmp)), nprocs=2, join=False)
    return procs, tmp, cj, pj


@pytest.fixture(scope="module")
def jax_refs(spawned):
    """Decode logits of the unruled JAX model, and the JAX engine's tokens
    and greedy margins per kv dtype."""
    _, _, cj, pj = spawned
    toks, nxt = _step_inputs(cj.vocab_size)
    cache = JM.init_cache(cj, 2, ENGINE["cache_len"], dtype=jnp.float32)
    _, cache = JM.prefill_step(cj, pj, cache, {"tokens": jnp.asarray(toks)},
                               0, jnp.asarray(STEP_POS0))
    decode = jax.jit(lambda c, t, p: JM.decode_step(cj, pj, c, {"tokens": t},
                                                    p))
    logits, pos = [], STEP_POS0
    for step in range(N_STEPS):
        o, cache = decode(cache, jnp.asarray(nxt[step]), jnp.asarray(pos))
        logits.append(np.asarray(o["logits"][:, -1]))
        pos = pos + 1
    out = {"logits_f32": np.stack(logits)}
    for kv in ("f32", "int8"):
        trace = jax_serve.gen_trace(6, vocab=cj.vocab_size, **TRACE)
        jax_serve.run_engine(cj, pj, trace, paged=False, kv_dtype=kv,
                             **ENGINE)
        margin = (jax_serve.min_accept_margin(cj, pj, trace,
                                              ENGINE["cache_len"])
                  if kv == "f32" else
                  _int8_margin(cj, pj, trace, ENGINE["cache_len"]))
        out[kv] = ({r.rid: list(r.tokens) for r in trace}, margin)
    return out


@pytest.fixture(scope="module")
def two_ranks(spawned, jax_refs):
    """Both ranks' results (joined), and the JAX references."""
    procs, tmp, _, _ = spawned
    while not procs.join(timeout=60):
        pass
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, jax_refs


MIN_MARGIN = {"f32": 1e-3, "int8": 1e-2}


def test_cp2_trace_has_healthy_margins(jax_refs):
    """The precondition of token identity: every greedy choice on the
    trace wins by far more than the logit noise of its kv dtype."""
    for kv, bound in MIN_MARGIN.items():
        margin = jax_refs[kv][1]
        assert margin >= bound, f"near-tie greedy choice ({margin}) at {kv}"


def test_cp2_decode_logits_match_jax(two_ranks):
    ranks, want = two_ranks
    for out in ranks:
        _close(out["logits_f32"], want["logits_f32"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ranks[0]["logits_f32"],
                                  ranks[1]["logits_f32"])


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_cp2_engine_tokens_match_jax_engine(two_ranks, kv):
    ranks, want = two_ranks
    tokens, margin = want[kv]
    assert margin >= MIN_MARGIN[kv]
    for out in ranks:
        rep, got = out[kv]
        assert rep["decode_layout"] == "decode_cp[2]"
        assert rep["kv_dtype"] == kv and rep["ranks_agree"]
        assert rep["logits_finite"] and rep["requests"] == len(tokens)
        assert rep["cp_combine_bytes_per_token"] == \
            traffic.decode_cp_combine_bytes(torch_config("yi-6b").reduced(),
                                            ENGINE["n_slots"], 2)
        assert got == tokens


def test_cp2_odd_cache_length_stays_replicated(two_ranks):
    """33 rows do not divide over two ranks: the cache stays whole on both
    (the JAX rule), the report says so, and the tokens do not change."""
    ranks, want = two_ranks
    for out in ranks:
        rep, got = out["f32_odd"]
        assert rep["decode_layout"] == "replicated"
        assert got == want["f32"][0]


def test_cp2_backend_follows_the_device(two_ranks):
    """A CUDA tensor needs an NCCL group: the gloo group refuses it."""
    for out in two_ranks[0]:
        assert "needs a nccl process group, got gloo" in out["mismatch"]
