"""The port's training kernels against the JAX package's Pallas kernels.

Same inputs, made with numpy from a seed, go through the Pallas kernel in
interpret mode and through the port: its plain version (``ref``), the
wrapper of the CUDA kernel and the dispatch entry with its autograd
``Function``, which on CPU tensors take the plain versions.  f32 agrees to
rtol = atol = 1e-5 (both sides sum in f32, in different orders).  The CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them to the
same plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import flash_attention_bwd as jax_flash_bwd  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels import shared_rmsprop as jax_rmsprop  # noqa: E402
from repro_torch.kernels import (dispatch, flash_attention_bwd_cuda,  # noqa: E402
                                 flash_attention_cuda, ref, rmsnorm_cuda,
                                 rmsprop_cuda)

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _attn_inputs(seed, b=2, s=256, hq=4, hkv=2, d=64):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, s, hq, d))
    k = _normal(rng, (b, s, hkv, d))
    v = _normal(rng, (b, s, hkv, d))
    do = _normal(rng, (b, s, hq, d))
    return q, k, v, do


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


ATTN_CASES = [("causal", True, None), ("window=96", True, 96),
              ("bidirectional", False, None)]


# ---------------------------------------------------------------------------
# flash attention forward and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,causal,window", ATTN_CASES)
def test_flash_fwd_matches_pallas(name, causal, window):
    q, k, v, _ = _attn_inputs(1)
    want_o, want_lse = jax_flash.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=128, block_k=128, save_residuals=True,
        interpret=True)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                     window=window)
    _close(o, want_o)
    _close(lse, want_lse)
    o, lse = flash_attention_cuda.flash_attention_fwd(
        qt, kt, vt, causal=causal, window=window)
    _close(o, want_o)
    _close(lse, want_lse)
    _close(dispatch.flash_attention(qt, kt, vt, causal=causal,
                                    window=window), want_o)


@pytest.mark.parametrize("name,causal,window", ATTN_CASES)
def test_flash_bwd_matches_pallas(name, causal, window):
    q, k, v, do = _attn_inputs(2)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = jax_flash.flash_attention_fwd(
        jq, jk, jv, causal=causal, window=window, block_q=128, block_k=128,
        save_residuals=True, interpret=True)
    want = jax_flash_bwd.flash_attention_bwd(
        jq, jk, jv, o, lse, jdo, causal=causal, window=window, block_q=128,
        block_k=128, interpret=True)

    # the wrapper, fed the Pallas forward's o and lse
    got = flash_attention_bwd_cuda.flash_attention_bwd(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w)

    # autograd through the dispatch entry (its own forward saves o, lse)
    qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
    out = dispatch.flash_attention(qt, kt, vt, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        assert g.shape == w.shape
        _close(g, w)


def test_flash_ragged_s_matches_reference_and_its_vjp():
    """S = 200 is no multiple of the Pallas blocks (the JAX dispatch sends
    it to the jnp reference); the port keeps it on its kernels."""
    q, k, v, do = _attn_inputs(3, s=200)
    for causal, window in ((True, None), (True, 50), (False, None)):
        o, vjp = jax.vjp(lambda q_, k_, v_: jax_ref.flash_attention_ref(
            q_, k_, v_, causal=causal, window=window),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
        qt, kt, vt = _leaf(q), _leaf(k), _leaf(v)
        out = dispatch.flash_attention(qt, kt, vt, causal=causal,
                                       window=window)
        _close(out.detach(), o)
        out.backward(torch.from_numpy(do))
        for g, w in zip((qt.grad, kt.grad, vt.grad), want):
            _close(g, w)


def test_flash_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 8, 4, 64)
    kv = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention_cuda.flash_attention_fwd(q, kv, kv)
    kv = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_cuda.flash_attention_fwd(q, kv.double(), kv)
    with pytest.raises(ValueError, match="window"):
        flash_attention_cuda.flash_attention_fwd(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda.flash_attention_bwd(
            q, kv, kv, q, torch.zeros(1, 8, 4), q)


# ---------------------------------------------------------------------------
# rmsnorm forward (rstd) and backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(64, 256), (10, 200)])
def test_rmsnorm_rstd_and_bwd_match_pallas(rows, d):
    rng = np.random.default_rng(rows + d)
    x = _normal(rng, (rows, d), 2.0)
    scale = _normal(rng, (d,), 0.5) + 1.0
    dy = _normal(rng, (rows, d))
    y, rstd = jax_rmsnorm.rmsnorm_fwd(jnp.asarray(x), jnp.asarray(scale),
                                      save_residuals=True, interpret=True)
    dx, dscale = jax_rmsnorm.rmsnorm_bwd(
        jnp.asarray(x), jnp.asarray(scale), rstd, jnp.asarray(dy),
        interpret=True)

    xt, st, dyt = (torch.from_numpy(a) for a in (x, scale, dy))
    got_y, got_rstd = rmsnorm_cuda.rmsnorm_fwd(xt, st, save_residuals=True)
    _close(got_y, y)
    _close(got_rstd, rstd)
    got_dx, got_ds = rmsnorm_cuda.rmsnorm_bwd(xt, st, got_rstd, dyt)
    _close(got_dx, dx)
    _close(got_ds, dscale)

    # autograd through the dispatch entry, on a (1, rows, d) activation
    x3, s1 = _leaf(x.reshape(1, rows, d)), _leaf(scale)
    out = dispatch.rmsnorm(x3, s1)
    _close(out.detach().reshape(rows, d), y)
    out.backward(torch.from_numpy(dy.reshape(1, rows, d)))
    _close(x3.grad.reshape(rows, d), dx)
    _close(s1.grad, dscale)


def test_rmsnorm_bwd_rejects_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="rstd"):
        rmsnorm_cuda.rmsnorm_bwd(x, torch.ones(8), torch.zeros(3), x)
    with pytest.raises(ValueError, match="dy"):
        rmsnorm_cuda.rmsnorm_bwd(x, torch.ones(8), torch.zeros(4),
                                 torch.zeros(4, 7))


# ---------------------------------------------------------------------------
# shared RMSProp
# ---------------------------------------------------------------------------

def test_rmsprop_matches_pallas_2d():
    rng = np.random.default_rng(7)
    g = np.abs(_normal(rng, (16, 1024)))
    grad = _normal(rng, (16, 1024), 3.0)
    lr = 7e-3
    new_g, upd = jax_rmsprop.rmsprop_update_2d(
        jnp.asarray(g), jnp.asarray(grad), jnp.asarray(lr, jnp.float32),
        alpha=0.99, eps=0.1, block_rows=8, interpret=True)
    gt = torch.from_numpy(g.copy())
    got_g, got_u = dispatch.rmsprop_update(gt, torch.from_numpy(grad),
                                           lr=lr, alpha=0.99, eps=0.1)
    assert got_g is gt                   # g' is written over g in place
    _close(got_g, new_g)
    _close(got_u, upd)


@pytest.mark.parametrize("shape", [(3000,), (60, 50), (1,), (5, 7, 3)])
def test_rmsprop_any_leaf_matches_jax_dispatch(shape):
    rng = np.random.default_rng(sum(shape))
    g = np.abs(_normal(rng, shape))
    grad = _normal(rng, shape)
    new_g, upd = jax_dispatch.rmsprop_update(
        jnp.asarray(g), jnp.asarray(grad), lr=3e-3, alpha=0.95, eps=0.1)
    got_g, got_u = rmsprop_cuda.rmsprop_update(
        torch.from_numpy(g.copy()), torch.from_numpy(grad), lr=3e-3,
        alpha=0.95, eps=0.1)
    assert got_u.shape == shape
    _close(got_g, new_g)
    _close(got_u, upd)


def test_rmsprop_rejects_bad_inputs():
    with pytest.raises(ValueError, match="differ"):
        rmsprop_cuda.rmsprop_update(torch.zeros(3), torch.zeros(4), lr=1.0)
    with pytest.raises(ValueError, match="float32"):
        rmsprop_cuda.rmsprop_update(torch.zeros(3).double(),
                                    torch.zeros(3).double(), lr=1.0)


def test_train_launch_counters_untouched_on_cpu():
    """CPU tensors take the plain versions: no launch is counted."""
    dispatch.reset_launch_counts()
    q, k, v, do = _attn_inputs(4, s=64)
    out = dispatch.flash_attention(_leaf(q), _leaf(k), _leaf(v))
    out.backward(torch.from_numpy(do))
    x = _leaf(np.ones((4, 64), np.float32))
    dispatch.rmsnorm(x, torch.ones(64)).sum().backward()
    dispatch.rmsprop_update(torch.zeros(5), torch.ones(5), lr=1.0)
    assert not any(dispatch.launch_counts().values())
