"""The port's kernel modules against the JAX package's Pallas kernels.

Same inputs, made with numpy from a seed, go through the Pallas kernel in
interpret mode and through the port: its plain version (``ref``), the
wrapper of the CUDA kernel and the dispatch entry, which on CPU tensors
take the plain version.  f32 agrees to rtol = atol = 1e-5: both sides sum
in f32, in different orders (online softmax over key blocks vs one
softmax).  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them to the same plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import rmsnorm as jax_rmsnorm  # noqa: E402
from repro_torch.kernels import (decode_attention_cuda, dispatch,  # noqa: E402
                                 flash_append_cuda, kv_quant, ref,
                                 rmsnorm_cuda)

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _ring_kpos(length, pos):
    """Slot s of a ring of ``length`` rows holds the largest position
    == s (mod length) at or below ``pos`` (-1 if none)."""
    idx = np.arange(length)
    cand = pos - (pos % length) + idx
    cand = np.where(cand > pos, cand - length, cand)
    return np.where(cand >= 0, cand, -1)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(16, 256), (5, 200), (64, 128)])
def test_rmsnorm_matches_pallas(rows, d):
    rng = np.random.default_rng(rows * 1000 + d)
    x = _normal(rng, (rows, d), 2.0)
    scale = _normal(rng, (d,), 0.5) + 1.0
    want = jax_rmsnorm.rmsnorm_fwd(jnp.asarray(x), jnp.asarray(scale),
                                   interpret=True)
    xt, st = torch.from_numpy(x), torch.from_numpy(scale)
    _close(ref.rmsnorm_ref(xt, st), want)
    _close(rmsnorm_cuda.rmsnorm_fwd(xt, st), want)
    # dispatch takes any rank: (B, S, d) reshaped to rows
    got = dispatch.rmsnorm(xt.reshape(1, rows, d), st)
    assert got.shape == (1, rows, d)
    _close(got.reshape(rows, d), want)


def test_rmsnorm_wrapper_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="scale"):
        rmsnorm_cuda.rmsnorm_fwd(x, torch.ones(7))
    with pytest.raises(ValueError, match="dtype"):
        rmsnorm_cuda.rmsnorm_fwd(x.half(), torch.ones(8))
    with pytest.raises(ValueError, match="scale dtype"):
        rmsnorm_cuda.rmsnorm_fwd(x, torch.ones(8, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(seed, b, hq, hkv, d, length):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hq, d)), _normal(rng, (b, length, hkv, d)),
            _normal(rng, (b, length, hkv, d)))


@pytest.mark.parametrize("case", ["ragged", "masked_row", "ring",
                                  "lockstep"])
def test_decode_matches_pallas(case):
    """GQA with G = 8 (8 q heads over one kv head), two key blocks."""
    b, hq, hkv, d, length = 3, 8, 1, 32, 64
    q, k, v = _decode_inputs(7, b, hq, hkv, d, length)
    pos = np.array([0, 21, 63], np.int32)
    kpos = np.where(np.arange(length)[None] <= pos[:, None],
                    np.arange(length)[None], -1).astype(np.int32)
    if case == "masked_row":        # an idle slot: nothing valid
        kpos[1] = -1
    elif case == "ring":            # rotated ring of a sliding window
        pos = np.array([5, 100, 200], np.int32)
        kpos = np.stack([_ring_kpos(length, p) for p in pos]) \
            .astype(np.int32)
    elif case == "lockstep":        # kpos (L,), scalar pos
        pos = np.int32(40)
        kpos = np.where(np.arange(length) <= pos, np.arange(length),
                        -1).astype(np.int32)
    want = jax_decode.decode_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
        jnp.asarray(pos), block_k=32, interpret=True)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    kpos_t = torch.as_tensor(kpos)
    pos_t = torch.as_tensor(pos)
    _close(dispatch.decode_attention(qt, kt, vt, kpos_t, pos_t), want)
    kb = kpos_t.expand(b, length).contiguous()
    pb = pos_t.expand(b).contiguous()
    _close(ref.decode_attention_ref(qt, kt, vt, kb, pb), want)
    _close(decode_attention_cuda.decode_attention_fwd(qt, kt, vt, kb, pb),
           want)


def test_decode_pos_none_means_max_kpos():
    b, hq, hkv, d, length = 2, 8, 2, 16, 32
    q, k, v = map(torch.from_numpy, _decode_inputs(3, b, hq, hkv, d, length))
    pos = torch.tensor([4, 30])
    kpos = torch.where(torch.arange(length)[None] <= pos[:, None],
                       torch.arange(length)[None], -1)
    _close(dispatch.decode_attention(q, k, v, kpos),
           dispatch.decode_attention(q, k, v, kpos, pos))


def test_decode_fully_masked_row_is_mean_of_v():
    """NEG is finite: a slot with no valid key attends uniformly."""
    b, hq, hkv, d, length = 1, 4, 1, 8, 16
    q, k, v = map(torch.from_numpy, _decode_inputs(5, b, hq, hkv, d, length))
    out = dispatch.decode_attention(q, k, v, torch.full((1, length), -1),
                                    torch.tensor([3]))
    assert torch.isfinite(out).all()
    _close(out[0], v[0, :, 0].mean(0).expand(hq, d))


def test_decode_rejects_gqa_and_quant():
    """GQA needs whole groups; quant inputs must come whole: int8 caches
    with both (B,L,Hkv,1) f32 scales, float caches with none."""
    q, k, v = map(torch.from_numpy, _decode_inputs(1, 1, 6, 4, 8, 16))
    kpos = torch.arange(16)
    with pytest.raises(ValueError, match="GQA"):
        dispatch.decode_attention(q, k, v, kpos, 3)
    q, k, v = map(torch.from_numpy, _decode_inputs(1, 1, 8, 4, 8, 16))
    with pytest.raises(ValueError, match="scale"):
        dispatch.decode_attention(q, k, v, kpos, 3,
                                  k_scale=torch.ones(1, 16, 4, 1),
                                  v_scale=torch.ones(1, 16, 4, 1))
    (k8, ks), (v8, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
    with pytest.raises(ValueError, match="scale"):
        dispatch.decode_attention(q, k8, v8, kpos, 3, k_scale=ks)
    with pytest.raises(ValueError, match="scale"):
        dispatch.decode_attention(q, k8, v8, kpos, 3, k_scale=ks[:, :8],
                                  v_scale=vs[:, :8])


# ---------------------------------------------------------------------------
# append attention (chunked prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos0,window,layout", [
    (0, None, "linear"),        # first chunk
    (16, None, "linear"),       # pos0 > 0: prefix + chunk
    (48, None, "linear"),       # deeper prefix, dead tiles skipped
    (48, 12, "linear"),         # window: prefix tiles below the floor
    (48, 32, "ring"),           # rotated ring prefix, no tile skip
    (16, None, "masked_row"),   # a batch row with no valid key
])
def test_append_matches_pallas(pos0, window, layout):
    """GQA with G = 8; chunk C = 16 in q blocks of 8, key blocks of 16."""
    b, c, hq, hkv, d = 2, 16, 8, 1, 32
    rng = np.random.default_rng(pos0 * 10 + (window or 0))
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
    k, v = _normal(rng, (b, sk, hkv, d)), _normal(rng, (b, sk, hkv, d))
    want = jax_flash.flash_attention_append(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos),
        pos0=pos0, window=window, block_q=8, block_k=16, kpos_linear=linear,
        interpret=True)
    qt, kt, vt, kpt = map(torch.from_numpy, (q, k, v, kpos))
    _close(ref.flash_attention_append_ref(qt, kt, vt, kpt, pos0=pos0,
                                          window=window), want)
    _close(flash_append_cuda.flash_attention_append(
        qt, kt, vt, kpt, pos0=pos0, window=window, kpos_linear=linear), want)
    _close(dispatch.flash_attention_append(qt, kt, vt, kpt, pos0=pos0,
                                           window=window,
                                           kpos_linear=linear), want)


def test_append_dispatch_broadcasts_1d_kpos():
    b, c, hq, hkv, d, pos0 = 2, 8, 4, 2, 16, 8
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_normal(rng, (b, c, hq, d)))
    k = torch.from_numpy(_normal(rng, (b, pos0 + c, hkv, d)))
    v = torch.from_numpy(_normal(rng, (b, pos0 + c, hkv, d)))
    kpos = torch.arange(pos0 + c)
    _close(dispatch.flash_attention_append(q, k, v, kpos, pos0=pos0),
           dispatch.flash_attention_append(q, k, v, kpos.expand(b, -1),
                                           pos0=pos0))


def test_kv_dtypes():
    assert kv_quant.resolve_kv_dtype("f32") == torch.float32
    assert kv_quant.resolve_kv_dtype("bf16") == torch.bfloat16
    assert kv_quant.resolve_kv_dtype(torch.bfloat16) == torch.bfloat16
    assert kv_quant.is_quantized(torch.int8)
    assert kv_quant.resolve_kv_dtype("int8") == torch.int8
    assert kv_quant.dtype_name(torch.int8) == "int8"
    with pytest.raises(ValueError):
        kv_quant.resolve_kv_dtype("fp8")


def test_launch_counters_untouched_on_cpu():
    """The CPU path runs the plain versions: no launch is counted."""
    dispatch.reset_launch_counts()
    dispatch.rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert dispatch.launch_counts() == {
        "rmsnorm": 0, "rmsnorm_bwd": 0, "flash_append": 0,
        "flash_append_int8": 0, "decode_attention": 0,
        "decode_attention_int8": 0, "decode_attention_partials": 0,
        "decode_attention_partials_int8": 0, "flash_attention": 0,
        "flash_attention_f32": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_f32": 0, "rmsprop": 0}
