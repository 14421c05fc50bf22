"""The port's paged KV layout against the JAX package on the CPU.

The paged arms gather pool pages into a dense view statically cut to the
logical cache length and run the contiguous kernels, so on the same bytes
they equal the contiguous layout bit for bit; the tests hold that in the
port (the arms, ``decode_step``, ``prefill_step`` and the engine) and hold
the port's plain versions, arms, host classes, capacity models and default
(paged) engine to the JAX package's: the same inputs made with numpy from
a seed, f32 to rtol = atol = 1e-5, tokens and page counters exactly.
Token identity across frameworks holds where every choice wins by far more
than the ~1e-6 by which their logits differ: the engine tests check
``min_accept_margin`` >= 1e-3 first.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels import kv_quant as jax_kv_quant  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import traffic as jax_traffic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import dispatch, kv_quant, ref  # noqa: E402
from repro_torch.launch import serve, traffic  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from tools.audit import alloc_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PS = 8                    # the engine tests' page size (cache_len 64)
ENGINE = dict(n_slots=2, cache_len=64, chunk=8, sample=False, seed=0,
              page_size=PS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engines run thousands of small ops, which intra-op threads only
    slow (several test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pool_case(seed, *, b=2, length=256, ps=128, hkv=2, d=64, unmapped=()):
    """A contiguous (B, L, Hkv, D) K/V pair scattered into a pool under a
    permuted page assignment (page 0 the sink, one spare page), with the
    (row, page index) entries of ``unmapped`` set to -1."""
    rng = np.random.default_rng(seed)
    m = length // ps
    k = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    pt = (1 + rng.permutation(b * m)).reshape(b, m).astype(np.int32)
    kp = rng.standard_normal((b * m + 2, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((b * m + 2, ps, hkv, d)).astype(np.float32)
    for bi in range(b):
        for mi in range(m):
            kp[pt[bi, mi]] = k[bi, mi * ps:(mi + 1) * ps]
            vp[pt[bi, mi]] = v[bi, mi * ps:(mi + 1) * ps]
    for bi, mi in unmapped:
        pt[bi, mi] = -1
    return k, v, kp, vp, pt


def _quant_pool(kp, vp):
    """int8 pools and their scale pools, the JAX package's bytes."""
    out = []
    for x in (kp, vp):
        q, s = jax_kv_quant.quantize(jnp.asarray(x))
        out += [np.asarray(q), np.asarray(s)]
    return out                      # kq, ks, vq, vs


# ---------------------------------------------------------------------------
# plain versions and dispatch arms against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [128, 64])
def test_paged_plain_versions_match_jax(ps):
    rng = np.random.default_rng(ps)
    _, _, kp, vp, pt = _pool_case(ps, ps=ps, unmapped=[(1, 256 // ps - 1)])
    q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    pos = np.array([200, 100], np.int32)
    np.testing.assert_array_equal(
        ref.paged_gather_ref(_t(kp), _t(pt)).numpy(),
        np.asarray(jax_ref.paged_gather_ref(jnp.asarray(kp),
                                            jnp.asarray(pt))))
    np.testing.assert_array_equal(
        ref.paged_kpos_ref(_t(pt), ps).numpy(),
        np.asarray(jax_ref.paged_kpos_ref(jnp.asarray(pt), ps)))
    _close(ref.decode_attention_paged_ref(_t(q), _t(kp), _t(vp), _t(pt),
                                          _t(pos), length=256),
           jax_ref.decode_attention_paged_ref(
               jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
               jnp.asarray(pt), jnp.asarray(pos), length=256))
    kq, ks, vq, vs = _quant_pool(kp, vp)
    _close(ref.decode_attention_paged_quant_ref(
        _t(q), _t(kq), _t(vq), _t(ks), _t(vs), _t(pt), _t(pos), length=256),
        jax_ref.decode_attention_paged_quant_ref(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
            jnp.asarray(pos), length=256))
    c = 32
    qc = rng.standard_normal((2, c, 8, 64)).astype(np.float32)
    kc = rng.standard_normal((2, c, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((2, c, 2, 64)).astype(np.float32)
    kcq, kcs = (np.asarray(t) for t in jax_kv_quant.quantize(
        jnp.asarray(kc)))
    vcq, vcs = (np.asarray(t) for t in jax_kv_quant.quantize(
        jnp.asarray(vc)))
    for pos0 in (0, ps + 16):
        _close(ref.flash_attention_append_paged_ref(
            _t(qc), _t(kp), _t(vp), _t(pt), _t(kc), _t(vc), pos0=pos0),
            jax_ref.flash_attention_append_paged_ref(
                jnp.asarray(qc), jnp.asarray(kp), jnp.asarray(vp),
                jnp.asarray(pt), jnp.asarray(kc), jnp.asarray(vc),
                pos0=pos0))
        _close(ref.flash_attention_append_paged_quant_ref(
            _t(qc), _t(kq), _t(vq), _t(ks), _t(vs), _t(pt), _t(kcq),
            _t(vcq), _t(kcs), _t(vcs), pos0=pos0),
            jax_ref.flash_attention_append_paged_quant_ref(
                jnp.asarray(qc), jnp.asarray(kq), jnp.asarray(vq),
                jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
                jnp.asarray(kcq), jnp.asarray(vcq), jnp.asarray(kcs),
                jnp.asarray(vcs), pos0=pos0))


@pytest.mark.parametrize("ps", [128, 64])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_arms_match_jax_dispatch(ps, quant):
    """The port's two dispatch arms against the JAX package's (its jnp
    paths on the CPU; page 64 takes its misalignment oracle)."""
    rng = np.random.default_rng(7 * ps + quant)
    _, _, kp, vp, pt = _pool_case(ps + 1, ps=ps, unmapped=[(0, 256 // ps - 1)])
    q = rng.standard_normal((2, 8, 64)).astype(np.float32)
    pos = np.array([97, 230], np.int32)
    scales = {}
    if quant:
        kp, ks, vp, vs = _quant_pool(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    got = dispatch.decode_attention_paged(
        _t(q), _t(kp), _t(vp), _t(pt), _t(pos), length=256,
        **{k: _t(x) for k, x in scales.items()})
    want = jax_dispatch.decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), length=256,
        **{k: jnp.asarray(x) for k, x in scales.items()})
    _close(got, want)
    c = 64
    qc = rng.standard_normal((2, c, 8, 64)).astype(np.float32)
    kc = rng.standard_normal((2, c, 2, 64)).astype(np.float32)
    vc = rng.standard_normal((2, c, 2, 64)).astype(np.float32)
    chunk = dict(k_chunk=kc, v_chunk=vc)
    if quant:
        (kc8, kcs), (vc8, vcs) = (
            [np.asarray(t) for t in jax_kv_quant.quantize(jnp.asarray(x))]
            for x in (kc, vc))
        chunk = dict(k_chunk=kc8, v_chunk=vc8, ks_chunk=kcs, vs_chunk=vcs)
    for pos0 in (0, 128):
        got = dispatch.flash_attention_append_paged(
            _t(qc), _t(kp), _t(vp), _t(pt), pos0=pos0,
            **{k: _t(x) for k, x in {**scales, **chunk}.items()})
        want = jax_dispatch.flash_attention_append_paged(
            jnp.asarray(qc), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), pos0=pos0,
            **{k: jnp.asarray(x) for k, x in {**scales, **chunk}.items()})
        _close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_arms_bitwise_match_contiguous(quant):
    """The paged arms equal the contiguous ones bit for bit: the decode arm
    over a permuted table with an unmapped tail page (masked the same way
    in the contiguous kpos), the append arm at pos0 0 (the pool unread)
    and one page in."""
    rng = np.random.default_rng(3 + quant)
    k, v, kp, vp, pt = _pool_case(11, unmapped=[(0, 1)])
    q = _t(rng.standard_normal((2, 8, 64)).astype(np.float32))
    pos = torch.tensor([100, 200], dtype=torch.int32)
    k, v, kp, vp, pt = map(_t, (k, v, kp, vp, pt))
    sc, sp = {}, {}
    if quant:
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
        (kp, kps), (vp, vps) = kv_quant.quantize(kp), kv_quant.quantize(vp)
        sc, sp = dict(k_scale=ks, v_scale=vs), dict(k_scale=kps,
                                                    v_scale=vps)
    idx = torch.arange(256, dtype=torch.int32)
    kpos = torch.stack([torch.where(idx < 128, idx, -1), idx])
    want = dispatch.decode_attention(q, k, v, kpos, pos, **sc)
    got = dispatch.decode_attention_paged(q, kp, vp, pt, pos, length=256,
                                          **sp)
    assert torch.equal(got, want)
    c = 128
    qc = _t(rng.standard_normal((2, c, 8, 64)).astype(np.float32))
    kc = _t(rng.standard_normal((2, c, 2, 64)).astype(np.float32))
    vc = _t(rng.standard_normal((2, c, 2, 64)).astype(np.float32))
    chunk = dict(k_chunk=kc, v_chunk=vc)
    if quant:
        (kc, kcs), (vc, vcs) = kv_quant.quantize(kc), kv_quant.quantize(vc)
        chunk = dict(k_chunk=kc, v_chunk=vc, ks_chunk=kcs, vs_chunk=vcs)
    pt[0, 1] = int(pt[1, 1])         # the prefix page mapped for both rows
    for pos0 in (0, 128):
        pre = {n: t[:, :pos0] for n, t in (("k", k), ("v", v))}
        if pos0:
            for n, pool in (("k", kp), ("v", vp)):
                pre[n] = ref.paged_gather_ref(pool, pt)[:, :pos0]
        stream = [torch.cat([pre["k"], chunk["k_chunk"]], 1),
                  torch.cat([pre["v"], chunk["v_chunk"]], 1)]
        scales = {}
        if quant:
            scales = {n: torch.cat([ref.paged_gather_ref(s, pt)[:, :pos0],
                                    chunk[c_]], 1)
                      for n, s, c_ in (("k_scale", kps, "ks_chunk"),
                                       ("v_scale", vps, "vs_chunk"))}
        want = dispatch.flash_attention_append(
            qc, *stream, torch.arange(pos0 + c), pos0=pos0,
            kpos_linear=True, **scales)
        got = dispatch.flash_attention_append_paged(
            qc, kp, vp, pt, pos0=pos0, **sp, **chunk)
        assert torch.equal(got, want), pos0


def test_append_paged_first_chunk_ignores_pool():
    rng = np.random.default_rng(5)
    q, kc, vc = (_t(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 16, 4, 64), (2, 16, 2, 64), (2, 16, 2, 64)))
    pool = _t(rng.standard_normal((3, 8, 2, 64)).astype(np.float32))
    pt = torch.full((2, 2), -1, dtype=torch.int32)
    want = dispatch.flash_attention_append(q, kc, vc, torch.arange(16),
                                           pos0=0, kpos_linear=True)
    got = dispatch.flash_attention_append_paged(q, pool, pool * 7, pt, kc,
                                                vc, pos0=0)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# model layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cj = jax_config("yi-6b").reduced()
    ct = torch_config("yi-6b").reduced()
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_model_paged_cache_bitwise_matches_contiguous(models, kv):
    """Chunked prefill and per-slot decode through ``init_cache(paged=)``
    (permuted pages, one table for both layers) give the contiguous
    layout's logits bit for bit."""
    _, ct, _, pt = models
    params = TM.cast_params(ct, pt)
    b, length, ps = 2, 64, 16
    dt = kv_quant.resolve_kv_dtype(kv)
    cont = TM.init_cache(ct, b, length, dtype=dt, device="cpu")
    paged = TM.init_cache(ct, b, length, dtype=dt, device="cpu",
                          paged=attn.PagedLayout(ps, b * length // ps + 1))
    assert all(layer["pt"] is paged["pt"] for layer in paged["layers"])
    rng = np.random.default_rng(1)
    paged["pt"].copy_(_t((1 + rng.permutation(b * length // ps)).reshape(
        b, -1).astype(np.int32)))
    toks = _t(rng.integers(0, ct.vocab_size, (b, 48)))
    for p0 in (0, 16, 32):
        batch = {"tokens": toks[:, p0:p0 + 16]}
        oc, _ = TM.prefill_step(ct, params, cont, batch, p0)
        op, _ = TM.prefill_step(ct, params, paged, batch, p0)
        assert torch.equal(oc["logits"], op["logits"]), p0
    pos = torch.tensor([48, 41])
    for i in range(3):
        batch = {"tokens": toks[:, i:i + 1]}
        oc, _ = TM.decode_step(ct, params, cont, batch, pos)
        op, _ = TM.decode_step(ct, params, paged, batch, pos)
        assert torch.equal(oc["logits"], op["logits"]), i
        pos = pos + 1


def test_init_paged_cache_requires_whole_pages():
    with pytest.raises(ValueError, match="whole-page"):
        attn.init_paged_kv_cache(2, 200, 2, 64, page_size=128, n_pages=5)
    cache = attn.init_paged_kv_cache(2, 256, 2, 64, page_size=128,
                                     n_pages=5, dtype="int8", device="cpu")
    assert attn.pool_leaves(cache) == ["kp", "vp", "kps", "vps"]
    assert cache["pt"].shape == (2, 2) and bool((cache["pt"] == -1).all())


# ---------------------------------------------------------------------------
# host classes and capacity models
# ---------------------------------------------------------------------------

def test_allocator_and_prefix_index_follow_jax():
    """The port's PageAllocator and PrefixIndex against the JAX package's,
    op for op over 400 random operations: the same pages, refcounts,
    versions, reservations and prefix hits."""
    rng = np.random.default_rng(0)
    pair = [(serve.PageAllocator(9), serve.PrefixIndex(4)),
            (jax_serve.PageAllocator(9), jax_serve.PrefixIndex(4))]
    held = []
    base = rng.integers(0, 50, 12)
    for _ in range(400):
        op = rng.integers(0, 7)
        n = int(rng.integers(0, 3))
        tail = rng.integers(0, 50, int(rng.integers(0, 9)))
        prompt = np.concatenate([base[:int(rng.integers(0, 13))], tail])
        out = []
        for al, idx in pair:
            if op == 0:
                out.append(al.try_alloc())
            elif op == 1 and al.reserved:
                out.append(al.try_alloc(reserved=True))
            elif op == 2:
                out.append(al.reserve(n))
            elif op == 3 and al.reserved >= n:
                al.unreserve(n)
            elif op == 4 and held:
                al.decref(held[-1])
            elif op == 5 and held:
                al.incref(held[0])
            elif op == 6:
                hits = idx.lookup(prompt, al)
                out.append(hits)
                pages = [p for p, _ in hits] + held[len(hits):]
                idx.register(prompt, pages, al)
        assert out[:1] == out[1:]
        if op == 0 and out[0] is not None:
            held.append(out[0])
        elif op == 4 and held and pair[0][0].ref[held[-1]] == 0:
            held.pop()
        a, b = pair[0][0], pair[1][0]
        assert (a.free, a.reserved, a.high_water) == \
            (b.free, b.reserved, b.high_water)
        np.testing.assert_array_equal(a.ref, b.ref)
        np.testing.assert_array_equal(a.version, b.version)
        assert pair[0][1].entries == pair[1][1].entries


def test_allocator_model_explores_cleanly():
    """``tools/audit``'s interleaving check over the port's model: no
    violation, and a COW fork, a recycled page, a reserved allocation and a
    preemption reached."""
    violations, stats = alloc_model.explore(serve.AllocatorModel(n_pages=4))
    assert violations == []
    for key in ("cow_forks", "recycle_reuse", "reserved_allocs",
                "preempts", "reserve_ops"):
        assert stats[key] > 0, key
    assert stats["states_explored"] > 100


def test_capacity_models_match_jax(models):
    """Reservation capacity, page pool and prefill bytes equal the JAX
    package's; paged capacity and cache bytes too, except the bytes of the
    layout's bookkeeping: the JAX cache holds an int32 ``index`` a layer
    and a page table a paged layer, the port's one table in all."""
    cj, ct, _, _ = models
    for kw in (dict(n_pages=7, page_size=64, prompt_tokens=86, max_new=64,
                    shared_tokens=64),
               dict(n_pages=33, page_size=128, prompt_tokens=600,
                    max_new=48),
               dict(n_pages=65, page_size=128, prompt_tokens=612,
                    max_new=64, shared_tokens=512)):
        assert traffic.reservation_capacity(**kw) == \
            jax_traffic.reservation_capacity(**kw)
    for kv in (None, "int8"):
        assert traffic.page_pool_bytes(ct, 33, 128, kv_dtype=kv) == \
            jax_traffic.page_pool_bytes(cj, 33, 128, kv_dtype=kv)
        kw = dict(n_slots=8, cache_len=1024, page_size=128,
                  resident_tokens_per_req=256, shared_tokens=128,
                  kv_dtype=kv)
        got = traffic.paged_capacity(ct, **kw)
        want = jax_traffic.paged_capacity(cj, **kw)
        n = ct.n_layers
        assert want["budget_bytes"] - got["budget_bytes"] == 4 * n
        assert want["per_slot_overhead_bytes"] - \
            got["per_slot_overhead_bytes"] == 4 * n + (n - 1) * 8 * 4
        for k in ("budget_bytes", "per_slot_overhead_bytes"):
            got.pop(k), want.pop(k)
        assert got == want
        assert traffic.cache_bytes(ct, 4, 1024, kv_dtype=kv) == \
            jax_traffic.cache_bytes(cj, 4, 1024, kv_dtype=kv) - 4 * n
        assert traffic.decode_bytes_per_token(ct, 4, 1024, kv_dtype=kv) == \
            jax_traffic.decode_bytes_per_token(cj, 4, 1024,
                                               kv_dtype=kv) - 4 * n
        paged = dict(kv_dtype=kv, page_size=128, n_pages=33)
        assert traffic.decode_bytes_per_token(ct, 4, 1024, **paged) == \
            jax_traffic.decode_bytes_per_token(cj, 4, 1024, **paged) \
            - 4 * n - (n - 1) * 4 * 8 * 4
    for fused in (True, False):
        assert traffic.prefill_attn_bytes(ct, 4, 600, 128, fused=fused) == \
            jax_traffic.prefill_attn_bytes(cj, 4, 600, 128, fused=fused)
    assert traffic.prefill_chunk_bytes(ct, 4, 600, 128) == \
        jax_traffic.prefill_chunk_bytes(cj, 4, 600, 128)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _shared_trace(mod, vocab, *, n=6, shared_len=20, seed=0):
    """A shared 20-token prefix (two whole pages and a half), distinct
    tails except rids 1 and 2, whose identical prompts share their partial
    last page until its first decode write forks it."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    dup = rng.integers(0, vocab, 5).astype(np.int32)
    out = []
    for rid in range(n):
        tail = dup if rid in (1, 2) else \
            rng.integers(0, vocab, 1 + (rid % 3) * 4).astype(np.int32)
        out.append(mod.Request(rid=rid, prompt=np.concatenate([shared, tail]),
                               max_new=2 + (rid % 3) * 4, arrival=0.0))
    return out


PAGE_KEYS = ("paged", "page_size", "n_pages", "pages_requested",
             "pages_alloced", "cow_events", "prefill_chunks_skipped",
             "dedup_ratio", "pool_high_water")
SEED = 2                  # a trace whose choices all win by >= 1e-3


@pytest.fixture(scope="module")
def jax_default(models):
    """The JAX engine's default (paged) runs on the shared-prefix trace:
    greedy f32, sampled f32 (jax's partitionable threefry, the port's
    default) and greedy int8, with the greedy f32 run's margin."""
    cj, _, pj, _ = models
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    runs = {}
    try:
        for name, kw in (("greedy", {}), ("sampled", dict(sample=True)),
                         ("int8", dict(kv_dtype="int8"))):
            trace = _shared_trace(jax_serve, cj.vocab_size, seed=SEED)
            rep = jax_serve.run_engine(cj, pj, trace, **{**ENGINE, **kw})
            runs[name] = (trace, rep)
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    margin = jax_serve.min_accept_margin(cj, pj, runs["greedy"][0],
                                         ENGINE["cache_len"])
    return runs, margin


@pytest.mark.parametrize("name", ["greedy", "sampled", "int8"])
def test_default_engine_matches_jax_default_engine(models, jax_default,
                                                   name):
    """``paged=None`` is paged on both sides here, and the port emits the
    JAX engine's tokens with its page counters: prefix hits, skipped
    chunks, the COW fork of the identical prompts."""
    runs, margin = jax_default
    assert margin >= 1e-3, f"trace has a near-tie greedy choice ({margin})"
    _, ct, _, pt = models
    trace_j, rep_j = runs[name]
    kw = {"sampled": dict(sample=True), "int8": dict(kv_dtype="int8")}
    kw = {**ENGINE, **kw.get(name, {})}
    if name == "sampled":
        m = serve.min_accept_margin(ct, pt, trace_j, ENGINE["cache_len"],
                                    key=prng.key(0), device="cpu")
        assert m >= 1e-3, f"trace has a near-tie sampled choice ({m})"
    trace = _shared_trace(serve, ct.vocab_size, seed=SEED)
    rep = serve.run_engine(ct, pt, trace, device="cpu", **kw)
    assert rep["paged"] and rep["logits_finite"]
    assert {r.rid: r.tokens for r in trace} == \
        {r.rid: list(r.tokens) for r in trace_j}
    assert {k: rep[k] for k in PAGE_KEYS} == {k: rep_j[k] for k in PAGE_KEYS}
    assert rep["cow_events"] > 0 and rep["prefill_chunks_skipped"] > 0
    assert rep["robustness"] == rep_j["robustness"]


def test_paged_engine_matches_contiguous_engine(models):
    """The port's paged and contiguous engines emit the same tokens, and
    their admission's first-token logits are the same bits: every choice
    comes from identical logits."""
    _, ct, _, pt = models
    out = {}
    for paged in (True, False):
        trace = _shared_trace(serve, ct.vocab_size, seed=SEED)
        rep = serve.run_engine(ct, pt, trace, device="cpu", paged=paged,
                               prefix_cache=False, **ENGINE)
        assert rep["paged"] == paged
        out[paged] = {r.rid: r.tokens for r in trace}
    assert out[True] == out[False]


def test_shared_prefix_matches_no_sharing(models):
    _, ct, _, pt = models
    recs, toks = {}, {}
    for share in (True, False):
        trace = _shared_trace(serve, ct.vocab_size, n=8, seed=SEED)
        recs[share] = serve.run_engine(ct, pt, trace, device="cpu",
                                       prefix_cache=share, **ENGINE)
        toks[share] = {r.rid: r.tokens for r in trace}
    on, off = recs[True], recs[False]
    assert toks[True] == toks[False]
    assert on["dedup_ratio"] > 1.0 and on["cow_events"] > 0
    assert on["prefill_chunks_skipped"] > 0
    assert off["dedup_ratio"] == 1.0 and off["prefill_chunks_skipped"] == 0
    assert on["pages_alloced"] < off["pages_alloced"]


def test_engine_shared_prefix_ring_archs(models):
    """A mixed attn/ring model: the global layers are paged, the ring
    layers stay contiguous and no chunk is skipped (a ring needs every
    chunk); the JAX engine's tokens and page counters, with sharing on and
    off.  A ring-only model has nothing to page."""
    cj, ct, pj, _ = models
    ring = dict(block_cycle=("attn", "attn_local"), sliding_window=8)
    cj, ct = (dataclasses.replace(c, **ring) for c in (cj, ct))
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    toks = {}
    for share in (True, False):
        trace_j = _shared_trace(jax_serve, cj.vocab_size, n=5, seed=SEED)
        rep_j = jax_serve.run_engine(cj, pj, trace_j, prefix_cache=share,
                                     **ENGINE)
        trace = _shared_trace(serve, ct.vocab_size, n=5, seed=SEED)
        rep = serve.run_engine(ct, pt, trace, device="cpu",
                               prefix_cache=share, **ENGINE)
        toks[share] = {r.rid: r.tokens for r in trace}
        assert toks[share] == {r.rid: list(r.tokens) for r in trace_j}
        assert {k: rep[k] for k in PAGE_KEYS} == \
            {k: rep_j[k] for k in PAGE_KEYS}
        assert rep["paged"] and rep["prefill_chunks_skipped"] == 0
    assert toks[True] == toks[False]
    assert jax_serve.min_accept_margin(cj, pj, trace_j,
                                       ENGINE["cache_len"]) >= 1e-3
    pure = dataclasses.replace(ct, block_cycle=("attn_local",))
    eng = serve.ServeEngine(pure, TM.init_params(pure, 0, "cpu"),
                            device="cpu", **ENGINE)
    assert not eng.paged


def _drive(eng, trace):
    """Admit into free slots and decode until the trace is served."""
    qi = 0
    while qi < len(trace) or any(r is not None for r in eng.req_of):
        pairs = []
        for j in range(eng.n_slots):
            if qi < len(trace) and eng.req_of[j] is None:
                pairs.append((trace[qi], j))
                qi += 1
        eng.admit(pairs, 0.0)
        if any(r is not None for r in eng.req_of):
            eng.decode_step_all()
    return {r.rid: list(r.tokens) for r in trace}


def test_engine_reset_reproduces_fresh_engine(models):
    """reset() then the same trace == a fresh engine: recycled pool pages
    and a cleared prefix index leak nothing."""
    _, ct, _, pt = models
    kw = dict(ENGINE, device="cpu")
    eng = serve.ServeEngine(ct, pt, **kw)
    assert eng.paged
    first = _drive(eng, _shared_trace(serve, ct.vocab_size, n=5))
    counters = (eng.pages_alloced, eng.cow_events, eng.prefill_chunks_skipped)
    eng.reset()
    assert eng.alloc.used_pages == 0 and not eng.prefix_index.entries
    assert bool((eng.cache["pt"] == -1).all())
    second = _drive(eng, _shared_trace(serve, ct.vocab_size, n=5))
    fresh = serve.ServeEngine(ct, pt, **kw)
    third = _drive(fresh, _shared_trace(serve, ct.vocab_size, n=5))
    assert first == second == third
    assert counters == (eng.pages_alloced, eng.cow_events,
                        eng.prefill_chunks_skipped) == \
        (fresh.pages_alloced, fresh.cow_events, fresh.prefill_chunks_skipped)


@pytest.mark.parametrize("cache_len,page_size", [(64, 8), (64, 128),
                                                 (96, 64), (256, 128)])
def test_paged_none_resolves_as_jax(models, cache_len, page_size):
    cj, ct, pj, pt = models
    kw = dict(n_slots=2, cache_len=cache_len, page_size=page_size)
    want = jax_serve.ServeEngine(cj, pj, **kw).paged
    assert serve.ServeEngine(ct, pt, device="cpu", **kw).paged == want
    assert want == (cache_len % page_size == 0)


def test_decode_cp_stays_contiguous(models):
    """Under decode_cp ``paged=None`` is contiguous, and ``paged=True`` is
    refused: a page pool has no sequence slice."""
    from repro_torch.distributed import sharding
    _, ct, _, pt = models
    kw = dict(n_slots=2, cache_len=64, page_size=8, device="cpu",
              decode_cp=True)
    with pytest.raises(ValueError, match="sequence slice"):
        serve.ServeEngine(ct, pt, paged=True, **kw)
    with sharding.process_group(torch.device("cpu")):
        eng = serve.ServeEngine(ct, pt, **kw)
    assert not eng.paged and eng.decode_layout == "decode_cp[1]"
