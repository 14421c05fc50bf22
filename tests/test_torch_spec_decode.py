"""The port's speculative decoding layers against the JAX package on the CPU.

Verify scores a slot's draft chunk through the append kernel at re-based
positions and writes nothing; commit writes the accepted rows.  The tests
hold the port's dispatch arms (contiguous and paged, f32 and int8, ragged
pos, K in {1, 4, 6}, a ring window), ``verify_step`` / ``commit_step``,
``make_verify_step``, the draft sources, the allocator model and the
traffic model to the JAX package's, on the same inputs made with numpy
from a seed: f32 tensors to rtol = atol = 1e-5, tokens, counts and
acceptance exactly.  Where each framework quantises its own f32 values to
int8, a value may fall one step apart (the convention of
``test_torch_kv_quant.py``): those int8 bytes are held within one step on
under 1 % of the elements, their scales to 1e-5.  The engine is held to
the JAX engine in ``test_torch_spec_engine.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import llm_a3c as jax_a3c  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels import kv_quant as jax_kv_quant  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import traffic as jax_traffic  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core import llm_a3c, prng  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve, traffic  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tools.audit import alloc_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _quant(x):
    """int8 bytes and scales of x, the JAX package's."""
    q, s = jax_kv_quant.quantize(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _one_step(got, want):
    """int8 tensors quantised on each side from f32 values ~1e-7 apart."""
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


# ---------------------------------------------------------------------------
# dispatch arms
# ---------------------------------------------------------------------------

def _cache_positions(length, pos, window):
    return np.asarray(jax_attn._cache_positions(length, jnp.asarray(pos),
                                                window))


@pytest.mark.parametrize("kq", [1, 4, 6])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, 16], ids=["linear", "ring"])
def test_verify_arm_matches_jax(kq, quant, window):
    """The contiguous verify arm on a stream built as ``attend_verify``
    builds it: the cache (a ring of ``window`` rows, or 64 linear rows)
    with every row at or past each slot's pos masked, then the chunk."""
    rng = np.random.default_rng(10 * kq + 2 * quant + (window or 0))
    b, hq, hkv, d = 3, 4, 2, 64
    length = window or 64
    pos = np.array([0, 17, 64 - kq], np.int32)
    q = rng.standard_normal((b, kq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, length + kq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, length + kq, hkv, d)).astype(np.float32)
    kpos = np.concatenate(
        [_cache_positions(length, pos - 1, window),
         pos[:, None] + np.arange(kq)[None]], axis=1).astype(np.int32)
    args = dict(pos=pos, shift=64, window=window)
    kw = {}
    if quant:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    dispatch.reset_launch_counts()
    got = dispatch.flash_attention_verify(
        _t(q), _t(k), _t(v), _t(kpos),
        **{n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in {**args, **kw}.items()})
    want = jax_dispatch.flash_attention_verify(
        _j(q), _j(k), _j(v), _j(kpos),
        **{n: _j(x) if isinstance(x, np.ndarray) else x
           for n, x in {**args, **kw}.items()})
    _close(got, want)
    assert dispatch.route_counts()["flash_verify"] == 1


@pytest.mark.parametrize("kq", [1, 4, 6])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_paged_arm_matches_jax(kq, quant):
    """The paged arm over a permuted table whose pages past each slot's
    pos hold garbage (a page mapped ahead of the verify, never written),
    one entry unmapped; the view cut to the logical length."""
    rng = np.random.default_rng(20 + kq + 7 * quant)
    b, hq, hkv, d, ps, m = 3, 4, 2, 64, 16, 4
    pt = (1 + rng.permutation(b * m)).reshape(b, m).astype(np.int32)
    pt[0, 3] = -1
    pools = [rng.standard_normal((b * m + 1, ps, hkv, d)).astype(np.float32)
             for _ in range(2)]
    pos = np.array([5, 33, 64 - kq], np.int32)
    q = rng.standard_normal((b, kq, hq, d)).astype(np.float32)
    chunk = [rng.standard_normal((b, kq, hkv, d)).astype(np.float32)
             for _ in range(2)]
    kw = dict(k_chunk=chunk[0], v_chunk=chunk[1])
    if quant:
        (kp, kps), (vp, vps) = (_quant(x) for x in pools)
        (kc, kcs), (vc, vcs) = (_quant(x) for x in chunk)
        pools = [kp, vp]
        kw = dict(k_chunk=kc, v_chunk=vc, k_scale=kps, v_scale=vps,
                  ks_chunk=kcs, vs_chunk=vcs)
    dispatch.reset_launch_counts()
    got = dispatch.flash_attention_verify_paged(
        _t(q), _t(pools[0]), _t(pools[1]), _t(pt), pos=_t(pos),
        length=m * ps, **{n: _t(x) for n, x in kw.items()})
    want = jax_dispatch.flash_attention_verify_paged(
        _j(q), _j(pools[0]), _j(pools[1]), _j(pt), pos=_j(pos),
        length=m * ps, **{n: _j(x) for n, x in kw.items()})
    _close(got, want)
    counts = dispatch.route_counts()
    assert counts["verify_paged"] == counts["flash_verify"] == 1


def test_verify_rebase_equals_per_row_append():
    """Re-basing changes nothing: each row of one verify call equals an
    append call of that row alone at its own pos0 (the masks are
    relative)."""
    rng = np.random.default_rng(3)
    b, kq, hq, hkv, d, length = 3, 4, 4, 2, 64, 32
    pos = torch.tensor([3, 20, 28], dtype=torch.int32)
    q = _t(rng.standard_normal((b, kq, hq, d)).astype(np.float32))
    k = _t(rng.standard_normal((b, length + kq, hkv, d)).astype(np.float32))
    v = _t(rng.standard_normal((b, length + kq, hkv, d)).astype(np.float32))
    idx = torch.arange(length)
    kpos = torch.cat([torch.where(idx[None] < pos[:, None], idx, -1),
                      pos[:, None] + torch.arange(kq)], dim=1)
    got = dispatch.flash_attention_verify(q, k, v, kpos, pos=pos,
                                          shift=length)
    for j in range(b):
        want = dispatch.flash_attention_append(
            q[j:j + 1], k[j:j + 1], v[j:j + 1], kpos[j:j + 1],
            pos0=int(pos[j]))
        torch.testing.assert_close(got[j:j + 1], want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# model layer
# ---------------------------------------------------------------------------

def _pair(arch="yi-6b", **over):
    cj = dataclasses.replace(jax_config(arch).reduced(), **over)
    ct = dataclasses.replace(torch_config(arch).reduced(), **over)
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return cj, ct, pj, pt


def _jax_layers(cache, cfg):
    """The JAX cache's layers as a list of numpy dicts (scan stacks
    unstacked), without the ``index`` leaf."""
    layers = cache["layers"]
    out = []
    for i in range(cfg.n_layers):
        if isinstance(layers, tuple):
            cyc = len(cfg.block_cycle)
            src = {n: a[i // cyc] for n, a in layers[i % cyc].items()}
        else:
            src = layers[i]
        out.append({n: np.asarray(a) for n, a in src.items()
                    if n not in ("index", "pt")})
    return out


def _jax_pendings(pend, cfg):
    if isinstance(pend, tuple):
        return _jax_layers({"layers": pend}, cfg)
    return [{n: np.asarray(a) for n, a in p.items()} for p in pend]


def _prefilled(cj, ct, pj, pt, *, b, length, kv, paged, toks, plen):
    """Both caches after one prefill chunk of ``plen`` rows: JAX's, and the
    port's loaded with the JAX cache's bytes (so each verify below reads
    the same cache on both sides)."""
    layout_j = jax_attn.PagedLayout(16, b * length // 16 + 1) \
        if paged else None
    layout_t = attn.PagedLayout(16, b * length // 16 + 1) if paged else None
    kvd_j = {"f32": jnp.float32, "int8": jnp.int8}[kv]
    cache_j = JM.init_cache(cj, b, length, dtype=jnp.float32,
                            paged=layout_j, kv_dtype=kvd_j)
    cache_t = TM.init_cache(ct, b, length, dtype=kv, device="cpu",
                            paged=layout_t)
    if paged:
        rng = np.random.default_rng(8)
        table = (1 + rng.permutation(b * length // 16)).reshape(b, -1)
        table = table.astype(np.int32)

        def put(layer):
            return {**layer, "pt": jnp.broadcast_to(jnp.asarray(table),
                                                    layer["pt"].shape)}
        lay = cache_j["layers"]
        cache_j = {**cache_j, "layers": tuple(put(x) for x in lay)
                   if isinstance(lay, tuple) else [put(x) for x in lay]}
        cache_t["pt"].copy_(_t(table))
    _, cache_j = JM.prefill_step(cj, pj, cache_j,
                                 {"tokens": _j(toks[:, :plen])}, 0)
    for lt, lj in zip(cache_t["layers"], _jax_layers(cache_j, cj)):
        for n, a in lj.items():
            lt[n].copy_(_t(a))
    return cache_j, cache_t


@pytest.mark.parametrize("case", ["contiguous", "ring", "paged",
                                  "paged_int8"])
def test_verify_and_commit_steps_match_jax(case):
    """``verify_step`` logits and pendings, then ``commit_step`` caches,
    against the JAX package's on the same cache bytes, with n_acc of 0, 1
    and K across the rows."""
    over = dict(block_cycle=("attn", "attn_local"), sliding_window=8) \
        if case == "ring" else {}
    cj, ct, pj, pt = _pair(**over)
    b, length, kq = 3, 64, 4
    kv = "int8" if case == "paged_int8" else "f32"
    paged = case.startswith("paged")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cj.vocab_size, (b, 48)).astype(np.int32)
    cache_j, cache_t = _prefilled(cj, ct, pj, pt, b=b, length=length, kv=kv,
                                  paged=paged, toks=toks, plen=32)
    pos = np.array([32, 20, 29], np.int32)
    chunk = rng.integers(0, cj.vocab_size, (b, kq)).astype(np.int32)
    out_j, pend_j = JM.verify_step(cj, pj, cache_j, {"tokens": _j(chunk)},
                                   _j(pos), length)
    params = TM.cast_params(ct, pt)
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in cache_t["layers"]]
    out_t, pend_t = TM.verify_step(ct, params, cache_t,
                                   {"tokens": _t(chunk)}, _t(pos), length)
    for lt, lb in zip(cache_t["layers"], before):  # verify wrote nothing
        assert all(torch.equal(lt[n], lb[n]) for n in lt)
    pend_jn = _jax_pendings(pend_j, cj)
    if kv == "f32":
        _close(out_t["logits"], out_j["logits"])
    for got, want in zip(pend_t, pend_jn):
        assert sorted(got) == sorted(want)
        for n in got:
            if got[n].dtype == torch.int8:
                _one_step(got[n], want[n])
            else:
                _close(got[n], want[n])
    n_acc = np.array([0, 1, kq], np.int32)
    cache_j = JM.commit_step(cj, cache_j, pend_j, _j(pos), _j(n_acc))
    TM.commit_step(ct, cache_t, pend_t, _t(pos), _t(n_acc))
    for lt, lj, lb in zip(cache_t["layers"], _jax_layers(cache_j, cj),
                          before):
        for n, a in lj.items():
            got = lt[n].numpy()
            if got.dtype == np.int8:
                _one_step(got, a)
            else:
                _close(got, a)
        # row 0 accepted nothing: its slots (and the sink) as before
        if not paged:
            for n in lt:
                assert torch.equal(lt[n][0], lb[n][0]), n


def test_commit_writes_only_accepted_rows():
    """A contiguous commit changes exactly the accepted (row, slot) pairs,
    each to its pending row; a paged one exactly the accepted rows of the
    mapped pages and, for the rest, only the sink page."""
    _, ct, _, pt = _pair()
    params = TM.cast_params(ct, pt)
    b, length, kq = 3, 64, 6
    rng = np.random.default_rng(9)
    pos = torch.tensor([10, 40, 58])
    n_acc = torch.tensor([2, 0, 6])
    chunk = _t(rng.integers(0, ct.vocab_size, (b, kq)))
    for paged in (False, True):
        cache = TM.init_cache(ct, b, length, dtype=torch.float32,
                              device="cpu",
                              paged=attn.PagedLayout(16, 13) if paged
                              else None)
        if paged:
            cache["pt"].copy_(torch.arange(1, 13, dtype=torch.int32)
                              .reshape(3, 4))
        for layer in cache["layers"]:
            for n in layer:
                if n != "pt":
                    layer[n].normal_()
        before = [{n: t.clone() for n, t in layer.items()}
                  for layer in cache["layers"]]
        _, pend = TM.verify_step(ct, params, cache, {"tokens": chunk}, pos,
                                 length)
        TM.commit_step(ct, cache, pend, pos, n_acc)
        for layer, old, p in zip(cache["layers"], before, pend):
            for n, leaf in (("kp", "k"), ("vp", "v")) if paged else \
                    (("k", "k"), ("v", "v")):
                want = old[n].clone()
                for j in range(b):
                    for i in range(int(n_acc[j])):
                        at = int(pos[j]) + i
                        if paged:
                            want[int(cache["pt"][j, at // 16]), at % 16] = \
                                p[leaf][j, i]
                        else:
                            want[j, at] = p[leaf][j, i]
                got = layer[n]
                if paged:           # the sink took the rejected rows
                    got, want = got[1:], want[1:]
                assert torch.equal(got, want), (paged, n)


# ---------------------------------------------------------------------------
# the fused verify step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_make_verify_step_matches_jax(sample):
    """Targets and n_acc of the fused step, exactly, on drafts that match
    the targets partly (the JAX step's own targets spliced in), with k_eff
    below K on a row and a remaining budget of 0 (idle) and 2."""
    cj, ct, pj, pt = _pair()
    b, length, kq = 4, 64, 5
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cj.vocab_size, (b, 48)).astype(np.int32)
    pos = np.array([32, 30, 31, 29], np.int32)
    sids = np.array([7, 3, 11, 0], np.int32)
    k_eff = np.array([5, 3, 5, 5], np.int32)
    remaining = np.array([9, 9, 2, 0], np.int32)
    key_j = jax.random.key(11)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        step_j = jax_a3c.make_verify_step(cj, length, sample=sample)
        chunk = rng.integers(0, cj.vocab_size, (b, kq)).astype(np.int32)
        cache_j, cache_t = _prefilled(cj, ct, pj, pt, b=b, length=length,
                                      kv="f32", paged=False, toks=toks,
                                      plen=32)

        def run_j():
            return step_j(pj, cache_j, {"tokens": _j(chunk)}, _j(pos),
                          key_j, _j(sids), _j(k_eff), _j(remaining))
        # drafts that follow the targets: rows 1 and 2 throughout, row 0
        # for its first three (target i depends on drafts up to i only)
        for i in range(1, kq):
            tj = np.asarray(run_j()[0])
            rows = [0, 1, 2] if i <= 3 else [1, 2]
            chunk[rows, i] = tj[rows, i - 1]
        tj, nj, _ = run_j()
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    step_t = llm_a3c.make_verify_step(ct, length, sample=sample)
    with prng.margins() as log:
        tt, nt, _ = step_t(TM.cast_params(ct, pt), cache_t,
                           {"tokens": _t(chunk)}, _t(pos), prng.key(11),
                           _t(sids), _t(k_eff), _t(remaining))
    if sample:
        assert log.smallest() > 1e-3, "a near-tie draw: identity undecided"
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert list(nt.numpy()) == [4, 3, 2, 0]


def test_verify_targets_are_plain_decode_tokens():
    """A fully accepted sampled round emits the tokens of K plain sampled
    decode steps: the (sid, position) streams do not depend on how many
    tokens a step commits."""
    _, ct, _, pt = _pair()
    params = TM.cast_params(ct, pt)
    b, length, kq = 2, 64, 4
    rng = np.random.default_rng(12)
    prompt = _t(rng.integers(0, ct.vocab_size, (b, 16)))
    key, sids = prng.key(3), torch.tensor([5, 9])
    caches = [TM.init_cache(ct, b, length, dtype=torch.float32,
                            device="cpu") for _ in range(2)]
    for c in caches:
        TM.prefill_step(ct, params, c, {"tokens": prompt}, 0)
    serve_step = llm_a3c.make_serve_step(ct, sample=True)
    tok = prompt[:, -1:]
    pos = torch.tensor([15, 15])
    plain = []
    with prng.margins() as log:
        for _ in range(kq):
            t, _, _ = serve_step(params, caches[0], {"tokens": tok}, pos,
                                 key, sids)
            plain.append(t)
            tok, pos = t[:, None], pos + 1
        chunk = torch.cat([prompt[:, -1:], torch.stack(plain[:-1], 1)], 1)
        # overwrite position 15 on the second cache as decode does
        step = llm_a3c.make_verify_step(ct, length, sample=True)
        targets, n_acc, _ = step(params, caches[1], {"tokens": chunk},
                                 torch.tensor([15, 15]), key, sids,
                                 torch.tensor([kq, kq]),
                                 torch.tensor([kq, kq]))
    assert log.smallest() > 1e-3
    assert torch.equal(targets, torch.stack(plain, 1))
    assert n_acc.tolist() == [kq, kq]


# ---------------------------------------------------------------------------
# draft sources, allocator model, traffic
# ---------------------------------------------------------------------------

def test_ngram_draft_matches_jax():
    rng = np.random.default_rng(0)
    dt, dj = serve.NgramDraft(), jax_serve.NgramDraft()
    hists = [list(rng.integers(0, 6, int(rng.integers(1, 40))))
             for _ in range(300)]
    period = list(rng.integers(0, 50, 5))
    hists += [(period * 12)[:n] for n in range(1, 60)]
    hists += [[int(x) for x in rng.integers(0, 1000, 30)]]
    for h in hists:
        h = [int(x) for x in h]
        for k in (2, 4, 6):
            assert dt.propose_one(h, k) == dj.propose_one(h, k), (h, k)
    # the suffix's latest earlier match continues with the period's start
    assert dt.propose_one(period * 3, 4) == [int(x) for x in period[:3]]


def test_draft_model_matches_jax():
    """The draft source: the reduced stablelm config with the target's
    vocabulary, its weights within 4 f32 ulps of the JAX draft's, and its
    drafts over a few rounds of admission, catch-up and partial accepts
    exactly."""
    ct, cj = torch_config("yi-6b").reduced(), jax_config("yi-6b").reduced()
    n, length, chunk = 2, 64, 16
    dt = serve.DraftModel(ct, n, length, chunk, seed=4, device="cpu")
    dj = jax_serve.DraftModel(cj, n, length, chunk, seed=4)
    # every field of the JAX config equal; the port's own further fields
    # at their defaults, which run what the JAX package runs
    ft, fj = dataclasses.asdict(dt.cfg), dataclasses.asdict(dj.cfg)
    assert {k: ft[k] for k in fj} == fj
    assert all(ft[f.name] == f.default for f in dataclasses.fields(dt.cfg)
               if f.name not in fj)
    assert dt.cfg.vocab_size == ct.vocab_size
    flat_j = TM.flatten(bridge.params_from_jax(
        dt.cfg, jax.tree.map(np.asarray, dj.params), device="cpu"))
    for name, got in TM.flatten(dt.params).items():
        want = flat_j[name]
        ulp = np.spacing(np.abs(want.numpy()).astype(np.float32))
        assert (np.abs(got.numpy() - want.numpy()) <= 4 * ulp).all(), name
    # run the port's draft on the JAX weights: then drafts are exact
    dt.params = TM.cast_params(dt.cfg, bridge.params_from_jax(
        dt.cfg, jax.tree.map(np.asarray, dj.params), device="cpu"))
    rng = np.random.default_rng(1)
    reqs = [serve.Request(rid=i, prompt=rng.integers(0, ct.vocab_size, 9 + i)
                          .astype(np.int32), max_new=20, arrival=0.0)
            for i in range(n)]
    for j, r in enumerate(reqs):
        r.tokens.append(int(rng.integers(0, ct.vocab_size)))
        dt.admit(r, j)
        dj.admit(r, j)
    active = np.ones(n, bool)
    for rnd, accepted in enumerate(((1, 3), (4, 2), (2, 1))):
        pos = np.array([len(r.prompt) + len(r.tokens) - 1 for r in reqs],
                       np.int32)
        tok = np.array([r.tokens[-1] for r in reqs], np.int32)
        hist = [[int(t) for t in r.prompt] + r.tokens for r in reqs]
        got = dt.propose(active, hist, pos, tok, 4)
        want = dj.propose(active, hist, pos, tok, 4)
        np.testing.assert_array_equal(got, want)
        new_pos = []
        for j, r in enumerate(reqs):
            # accept a prefix of the drafts, then one other token
            r.tokens += [int(x) for x in got[j, :accepted[j] - 1]]
            r.tokens.append(int(rng.integers(0, ct.vocab_size)))
            new_pos.append(len(r.prompt) + len(r.tokens) - 1)
        dt.observe(range(n), new_pos)
        dj.observe(range(n), new_pos)
        np.testing.assert_array_equal(dt.dpos, dj.dpos)


def test_allocator_model_explores_spec_ops_as_jax():
    """``tools/audit``'s interleaving check over the port's model with the
    speculative ops: no violation, a spec rewind and a spec commit
    reached, and the JAX model's state space exactly."""
    violations, stats = alloc_model.explore(serve.AllocatorModel(n_pages=4))
    assert violations == []
    for key in ("spec_allocs", "rewinds", "spec_commits", "cow_forks",
                "preempts", "reserved_allocs"):
        assert stats[key] > 0, key
    _, want = alloc_model.explore(jax_serve.AllocatorModel(n_pages=4))
    assert stats == want


def test_spec_traffic_matches_jax():
    for arch in ("yi-6b", "stablelm-1.6b"):
        ct, cj = torch_config(arch), jax_config(arch)
        assert traffic.spec_verify_bytes_per_token(ct) == \
            jax_traffic.spec_verify_bytes_per_token(cj)
        assert traffic.spec_wasted_bytes(ct, 37) == \
            jax_traffic.spec_wasted_bytes(cj, 37)


def test_validate_trace_charges_the_spec_tail():
    """A request whose pages fit without speculation but not with its
    spec_k - 1 tail is refused, as the JAX engine refuses it."""
    req = [serve.Request(rid=0, prompt=np.zeros(60, np.int32), max_new=4,
                         arrival=0.0)]
    serve._validate_trace(req, 128, page_size=16, usable_pages=4)
    with pytest.raises(ValueError, match="spec_k 4"):
        serve._validate_trace(req, 128, page_size=16, usable_pages=4,
                              spec_k=4)
    with pytest.raises(ValueError, match="spec_k 4"):
        jax_serve._validate_trace(req, 128, page_size=16, usable_pages=4,
                                  spec_k=4)
