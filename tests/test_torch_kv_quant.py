"""The port's int8 KV cache against the JAX package's on the CPU.

``kv_quant.quantize`` must land the JAX package's bytes (int8 payload
identical, f32 scales within 1e-7 relative); the int8 decode and append
plain versions, wrappers and dispatch entries (CPU tensors) must match the
Pallas kernels in interpret mode with their in-body dequantisation to
rtol = atol = 1e-5 (f32 sums in another order); rows beyond kpos may hold
any bytes and scales without moving the output; and the reduced model
writes the int8 caches ``repro.models.model`` writes.  Logits over int8
caches are compared end to end by the engines' greedy tokens
(``test_torch_decode_cp.py``): two frameworks' f32 sums differ by about
1e-6, which can move a quantised value across a rounding boundary by one
step, and that step moves logits by up to about 2e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import kv_quant as jax_kvq  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.kernels import (decode_attention_cuda, dispatch,  # noqa: E402
                                 flash_append_cuda, kv_quant, ref)
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _quant_np(x):
    """JAX quantize of a numpy array -> numpy (int8, scale)."""
    q, s = jax_kvq.quantize(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _ring_kpos(length, pos):
    idx = np.arange(length)
    cand = pos - (pos % length) + idx
    cand = np.where(cand > pos, cand - length, cand)
    return np.where(cand >= 0, cand, -1)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "wide", "zero_rows", "ties",
                                  "bf16"])
def test_quantize_bytes_match_jax(case):
    rng = np.random.default_rng(11)
    x = _normal(rng, (3, 40, 4, 64))
    if case == "wide":            # rows spanning many magnitudes
        x *= np.exp(_normal(rng, (3, 40, 4, 1), 3.0))
    elif case == "zero_rows":     # an all-zero row quantises with scale 0
        x[:, ::3] = 0.0
    elif case == "ties":          # x / scale lands on .5: half to even
        x[...] = np.arange(64, dtype=np.float32) - 31.5
        x[..., 0] = 127.0
    if case == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q8, scale = kv_quant.quantize(xt)
    qj, sj = jax_kvq.quantize(xj)
    assert q8.dtype == torch.int8 and scale.dtype == torch.float32
    assert scale.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(qj))
    np.testing.assert_allclose(scale.numpy(), np.asarray(sj), rtol=1e-7,
                               atol=0)
    back = kv_quant.dequantize(q8, scale)
    _close(back, jax_kvq.dequantize(qj, sj), rtol=1e-7, atol=0)
    if case == "zero_rows":
        assert not back[:, ::3].any()


# ---------------------------------------------------------------------------
# int8 decode attention (kernel 6's int8 arm)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged", "masked_row", "ring",
                                  "lockstep"])
def test_int8_decode_matches_pallas(case):
    """GQA with G = 4 (8 q heads over 2 kv heads), D = 64, L = 256 in two
    key blocks; the caches int8 with per-(row, head) scales."""
    b, hq, hkv, d, length = 2, 8, 2, 64, 256
    rng = np.random.default_rng(5)
    q = _normal(rng, (b, hq, d))
    k8, ks = _quant_np(_normal(rng, (b, length, hkv, d)))
    v8, vs = _quant_np(_normal(rng, (b, length, hkv, d)))
    k8, ks, v8, vs = (a.copy() for a in (k8, ks, v8, vs))
    pos = np.array([37, 255], np.int32)
    kpos = np.where(np.arange(length)[None] <= pos[:, None],
                    np.arange(length)[None], -1).astype(np.int32)
    if case == "masked_row":
        kpos[1] = -1
    elif case == "ring":
        pos = np.array([300, 1000], np.int32)
        kpos = np.stack([_ring_kpos(length, p) for p in pos]).astype(np.int32)
    elif case == "lockstep":
        pos = np.int32(130)
        kpos = np.where(np.arange(length) <= pos, np.arange(length),
                        -1).astype(np.int32)
    want = jax_decode.decode_attention_fwd(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(kpos),
        jnp.asarray(pos), block_k=128, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    qt, kt, vt, kst, vst = map(torch.from_numpy, (q, k8, v8, ks, vs))
    kpos_t, pos_t = torch.as_tensor(kpos), torch.as_tensor(pos)
    _close(dispatch.decode_attention(qt, kt, vt, kpos_t, pos_t, k_scale=kst,
                                     v_scale=vst), want)
    kb = kpos_t.expand(b, length).contiguous()
    pb = pos_t.expand(b).contiguous()
    _close(ref.decode_attention_quant_ref(qt, kt, vt, kst, vst, kb, pb),
           want)
    _close(decode_attention_cuda.decode_attention_fwd(qt, kt, vt, kb, pb,
                                                      kst, vst), want)


def test_garbage_rows_never_poison_output():
    """Rows beyond kpos validity may hold any int8 bytes and any scales
    (the JAX package's test of the same name): the output does not move,
    for the normalised decode and for its partials."""
    b, hq, hkv, d, length = 2, 8, 2, 64, 256
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_normal(rng, (b, hq, d)))
    k8, ks = kv_quant.quantize(torch.from_numpy(
        _normal(rng, (b, length, hkv, d))))
    v8, vs = kv_quant.quantize(torch.from_numpy(
        _normal(rng, (b, length, hkv, d))))
    pos = torch.tensor([150, 99])
    kpos = torch.where(torch.arange(length)[None] <= pos[:, None],
                       torch.arange(length)[None], -1)
    live = (torch.arange(length)[None, :, None, None]
            <= pos[:, None, None, None])
    junk = dict(k_scale=torch.where(live, ks, 1e6),
                v_scale=torch.where(live, vs, 0.0))
    junk_k = torch.where(live, k8, torch.tensor(127, dtype=torch.int8))
    junk_v = torch.where(live, v8, torch.tensor(-128, dtype=torch.int8))
    base = dispatch.decode_attention(q, k8, v8, kpos, pos, k_scale=ks,
                                     v_scale=vs)
    poisoned = dispatch.decode_attention(q, junk_k, junk_v, kpos, pos,
                                         **junk)
    assert float((base - poisoned).abs().max()) <= 1e-6
    kp, pp = kpos.to(torch.int32), pos.to(torch.int32)
    for a, c in zip(decode_attention_cuda.decode_attention_partials(
            q, k8, v8, kp, pp, ks, vs),
            decode_attention_cuda.decode_attention_partials(
            q, junk_k, junk_v, kp, pp, junk["k_scale"], junk["v_scale"])):
        assert float((a - c).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# int8 append attention (kernel 4's int8 arm)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos0,window,layout", [
    (0, None, "linear"),        # first chunk
    (48, None, "linear"),       # prefix + chunk, dead tiles skipped
    (48, 32, "ring"),           # rotated ring prefix
    (16, None, "masked_row"),   # a batch row with no valid key
])
def test_int8_append_matches_pallas(pos0, window, layout):
    """GQA with G = 4; chunk C = 16 in q blocks of 8, key blocks of 16; the
    key stream int8 (prefix as stored, chunk quantised once)."""
    b, c, hq, hkv, d = 2, 16, 8, 2, 64
    rng = np.random.default_rng(pos0 + 1)
    if layout == "ring":
        kpos = np.concatenate([_ring_kpos(window, pos0 - 1),
                               pos0 + np.arange(c)])
    else:
        kpos = np.arange(pos0 + c)
    sk = kpos.shape[0]
    kpos = np.broadcast_to(kpos, (b, sk)).astype(np.int32).copy()
    if layout == "masked_row":
        kpos[1] = -1
    linear = layout == "linear"
    q = _normal(rng, (b, c, hq, d))
    k8, ks = _quant_np(_normal(rng, (b, sk, hkv, d)))
    v8, vs = _quant_np(_normal(rng, (b, sk, hkv, d)))
    k8, ks, v8, vs = (a.copy() for a in (k8, ks, v8, vs))
    want = jax_flash.flash_attention_append(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(kpos),
        pos0=pos0, window=window, block_q=8, block_k=16, kpos_linear=linear,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    qt, kt, vt, kst, vst, kpt = map(torch.from_numpy,
                                    (q, k8, v8, ks, vs, kpos))
    _close(ref.flash_attention_append_quant_ref(
        qt, kt, vt, kst, vst, kpt, pos0=pos0, window=window), want)
    _close(flash_append_cuda.flash_attention_append(
        qt, kt, vt, kpt, pos0=pos0, window=window, kpos_linear=linear,
        k_scale=kst, v_scale=vst), want)
    _close(dispatch.flash_attention_append(
        qt, kt, vt, kpt, pos0=pos0, window=window, kpos_linear=linear,
        k_scale=kst, v_scale=vst), want)


def test_append_rejects_partial_quant_inputs():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, (1, 4, 4, 16)))
    k8, ks = kv_quant.quantize(torch.from_numpy(_normal(rng, (1, 4, 2, 16))))
    kpos = torch.arange(4)
    with pytest.raises(ValueError, match="scale"):
        dispatch.flash_attention_append(q, k8, k8, kpos, pos0=0, k_scale=ks)
    with pytest.raises(ValueError, match="scale"):
        dispatch.flash_attention_append(q, k8.float(), k8.float(), kpos,
                                        pos0=0, k_scale=ks, v_scale=ks)


# ---------------------------------------------------------------------------
# the model over an int8 cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "stablelm-1.6b"])
def test_int8_cache_writes_match_jax(arch):
    """The reduced model cut to one layer, over an int8 cache: two prefill
    chunks (right-padded rows) and three per-slot decode steps, the tokens
    the same on both sides.  The cache holds the JAX package's bytes:
    scales within 1e-5 relative (each is the absmax of f32 projections that
    XLA and PyTorch sum in other orders, about 1e-7 apart), int8 rows
    identical except where a value sits on a rounding boundary, which that
    difference can move by one step (at most one step, on under 1% of the
    elements; a wrong row, position or scale would move far more).  One
    layer, because a deeper layer's K/V come out of attention over the
    quantised cache, where each such step grows into a difference of about
    1e-4 of the next layer's scales."""
    cj = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                             n_layers=1)
    ct = dataclasses.replace(torch_configs.get_config(arch).reduced(),
                             n_layers=1)
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    b, cache_len = 2, 32
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cj.vocab_size, (b, 24)).astype(np.int32)
    true_len = np.array([24, 20], np.int32)
    cache_j = JM.init_cache(cj, b, cache_len, dtype=jnp.float32,
                            kv_dtype=jnp.int8)
    cache_t = TM.init_cache(ct, b, cache_len, dtype=torch.int8, device="cpu")
    jprefill = jax.jit(lambda p, c, t, tl, pos0: JM.prefill_step(
        cj, p, c, {"tokens": t}, pos0, tl), static_argnums=(4,))
    for p0, c in ((0, 16), (16, 8)):
        _, cache_j = jprefill(pj, cache_j, jnp.asarray(toks[:, p0:p0 + c]),
                              jnp.asarray(true_len), p0)
        TM.prefill_step(ct, pt, cache_t,
                        {"tokens": torch.from_numpy(toks[:, p0:p0 + c])}, p0,
                        torch.from_numpy(true_len))
    jdecode = jax.jit(lambda p, c, t, pos: JM.decode_step(
        cj, p, c, {"tokens": t}, pos))
    pos = np.array([24, 20], np.int32)
    for _ in range(3):
        nxt = rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
        _, cache_j = jdecode(pj, cache_j, jnp.asarray(nxt), jnp.asarray(pos))
        TM.decode_step(ct, pt, cache_t, {"tokens": torch.from_numpy(nxt)},
                       torch.from_numpy(pos))
        pos = pos + 1
    layers = cache_j["layers"]
    for i, layer in enumerate(cache_t["layers"]):
        if isinstance(layers, tuple):
            cyc = len(cj.block_cycle)
            lj = {n: np.asarray(a[i // cyc])
                  for n, a in layers[i % cyc].items() if n != "index"}
        else:
            lj = {n: np.asarray(a) for n, a in layers[i].items()
                  if n != "index"}
        assert sorted(lj) == sorted(layer)
        for n in ("k", "v"):
            diff = np.abs(layer[n].numpy().astype(np.int32) -
                          lj[n].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (i, n)
        for n in ("ks", "vs"):
            np.testing.assert_allclose(layer[n].numpy(), lj[n], rtol=1e-5,
                                       atol=0)
