"""The query-offset arm of the flash kernels' plain versions (kernels 3 and
5 under the sequence-sharded attention), against the JAX package.

Under the sequence arm each model rank holds Sq = S / tp rows of the
sequence, at positions r Sq .. (r + 1) Sq - 1, and attends them against
all S keys: ``ref.flash_attention_ref(q, k, v, q_offset=r Sq)`` and its
backward, which the CUDA kernels' offset arms are held to on the card.
Here, on the CPU:

- the oracle is ``repro.kernels.ref.flash_attention_ref`` on the whole
  sequence, sliced to the shard's rows; its gradients come from
  ``jax.vjp`` with a cotangent that is nonzero only on those rows.  The
  port's plain forward and backward of the shard (and ``dispatch``'s
  differentiable call on CPU tensors) agree with it to 1e-5 in f32, at
  the first, a middle and the last shard's offset: causal with no
  window, with a window shorter than the offset and with one that reaches
  back past the shard's first row, bidirectional, MHA and GQA, and a
  shard of rows that is not a multiple of 64;
- the shard-sum property for tp in {2, 4, 8}: the shards' forwards put
  back in order equal the unsharded plain forward within 1e-6, dq put
  back in order and dk, dv summed over the shards equal the unsharded
  backward within 1e-5;
- the wrappers' shape rules for the offset and their counters on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import (build, dispatch,  # noqa: E402
                                 flash_attention_bwd_cuda,
                                 flash_attention_cuda, ref)

TOL = 1e-5
D = 64

# (label, S, tp, Hq, Hkv, causal, window): the shard's rows Sq = S / tp
CASES = [
    ("causal MHA", 256, 4, 4, 4, True, None),
    ("causal GQA", 256, 4, 6, 2, True, None),
    # a window (24 keys) shorter than every shard's offset but the first
    ("window below the offset", 256, 4, 4, 2, True, 24),
    # a window (100 keys) that reaches back past the shard's first row
    ("window past the first row", 256, 4, 4, 4, True, 100),
    ("bidirectional GQA", 256, 4, 6, 3, False, None),
    # Sq = 100, not a multiple of 64
    ("ragged Sq", 200, 2, 4, 2, True, None),
    ("ragged Sq window", 200, 2, 4, 1, True, 37),
]


def _inputs(seed, s, hq, hkv):
    rng = np.random.default_rng(seed)
    shapes = ((1, s, hq, D), (1, s, hkv, D), (1, s, hkv, D), (1, s, hq, D))
    return [rng.standard_normal((2,) + sh[1:]).astype(np.float32)
            for sh in shapes]


def _shards(tp):
    """The first, a middle and the last shard."""
    return sorted({0, tp // 2, tp - 1})


def _jax_shard(q, k, v, do, lo, hi, causal, window):
    """The whole sequence's oracle, sliced to rows [lo, hi), and its
    gradients for a cotangent nonzero only on those rows."""
    def f(q_, k_, v_):
        return jax_ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                           window=window)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cot = np.zeros_like(q)
    cot[:, lo:hi] = do[:, lo:hi]
    dq, dk, dv = vjp(jnp.asarray(cot))
    return (np.asarray(out)[:, lo:hi], np.asarray(dq)[:, lo:hi],
            np.asarray(dk), np.asarray(dv))


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_offset_shard_matches_jax(case):
    label, s, tp, hq, hkv, causal, window = case
    q, k, v, do = _inputs(len(label), s, hq, hkv)
    sq = s // tp
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    for r in _shards(tp):
        lo, hi = r * sq, (r + 1) * sq
        o_w, dq_w, dk_w, dv_w = _jax_shard(q, k, v, do, lo, hi, causal,
                                           window)
        qs = torch.from_numpy(q[:, lo:hi].copy())
        dos = torch.from_numpy(do[:, lo:hi].copy())
        o, lse = ref.flash_attention_ref(qs, kt, vt, causal=causal,
                                         window=window, q_offset=lo)
        assert tuple(lse.shape) == (2, hq, sq)
        _close(o, o_w, f"{label} shard {r} o")
        dq, dk, dv = ref.flash_attention_bwd_ref(
            qs, kt, vt, o, lse, dos, causal=causal, window=window,
            q_offset=lo)
        assert dk.shape == kt.shape and dv.shape == vt.shape
        for name, g, w in (("dq", dq, dq_w), ("dk", dk, dk_w),
                           ("dv", dv, dv_w)):
            _close(g, w, f"{label} shard {r} {name}")
        # the differentiable call the model layer makes, on CPU tensors
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (qs, kt, vt))
        out = dispatch.flash_attention(qg, kg, vg, causal=causal,
                                       window=window, q_offset=lo)
        _close(out, o_w, f"{label} shard {r} dispatch o")
        grads = torch.autograd.grad(out, (qg, kg, vg), dos)
        for name, g, w in zip(("dq", "dk", "dv"), grads, (dq_w, dk_w, dv_w)):
            _close(g, w, f"{label} shard {r} dispatch {name}")


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 20),
                                           (False, None)])
def test_shards_sum_to_the_unsharded_plain_version(tp, causal, window):
    s, hq, hkv = 192, 4, 2
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(tp, s, hq, hkv))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    sq = s // tp
    outs, lses, dqs = [], [], []
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(tp):
        rows = slice(r * sq, (r + 1) * sq)
        o_r, lse_r = ref.flash_attention_ref(q[:, rows], k, v, causal=causal,
                                             window=window, q_offset=r * sq)
        g = ref.flash_attention_bwd_ref(q[:, rows], k, v, o_r, lse_r,
                                        do[:, rows], causal=causal,
                                        window=window, q_offset=r * sq)
        outs.append(o_r)
        lses.append(lse_r)
        dqs.append(g[0])
        dk_sum += g[1]
        dv_sum += g[2]
    torch.testing.assert_close(torch.cat(outs, 1), o, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat(lses, 2), lse, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.cat(dqs, 1), dq, rtol=0, atol=1e-5)
    torch.testing.assert_close(dk_sum, dk, rtol=0, atol=1e-5)
    torch.testing.assert_close(dv_sum, dv, rtol=0, atol=1e-5)


def test_unreached_keys_get_zero_gradients():
    """A causal shard's dk and dv are zero at every key past its last
    row: no query of the shard reaches them."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 128, 4, 2))
    rows = slice(32, 64)
    o, lse = ref.flash_attention_ref(q[:, rows], k, v, q_offset=32)
    _, dk, dv = ref.flash_attention_bwd_ref(q[:, rows], k, v, o, lse,
                                            do[:, rows], q_offset=32)
    assert bool((dk[:, 64:] == 0).all()) and bool((dv[:, 64:] == 0).all())
    assert bool((dk[:, :64] != 0).any())


def test_wrappers_check_the_offset():
    q = torch.zeros(1, 32, 2, D)
    k = torch.zeros(1, 64, 2, D)
    # keys longer than q without an offset, or too few for it
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_cuda.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_cuda.flash_attention_fwd(q, k, k, q_offset=33)
    with pytest.raises(ValueError, match="do not match"):
        flash_attention_cuda.flash_attention_fwd(q, k, k, q_offset=-1)
    o, lse = flash_attention_cuda.flash_attention_fwd(q, k, k, q_offset=32)
    assert o.shape == q.shape and tuple(lse.shape) == (1, 2, 32)
    dq, dk, dv = flash_attention_bwd_cuda.flash_attention_bwd(
        q, k, k, o, lse, q, q_offset=32)
    assert dq.shape == q.shape and dk.shape == k.shape


def test_offset_counters_untouched_on_cpu():
    dispatch.reset_launch_counts()
    q = torch.randn(1, 16, 2, D, requires_grad=True)
    k = torch.randn(1, 32, 2, D, requires_grad=True)
    dispatch.flash_attention(q, k, k, q_offset=16).sum().backward()
    counts = dispatch.launch_counts()
    for name in ("flash_attention_offset", "flash_attention_offset_f32",
                 "flash_attention_bwd_offset",
                 "flash_attention_bwd_offset_f32"):
        assert counts[name] == 0


@pytest.mark.parametrize("hq,hkv,sq,sk,splits", [
    (32, 4, 1024, 1024, 4), (40, 8, 4096, 4096, 5), (36, 36, 64, 64, 1),
    (40, 8, 256, 4096, 1), (32, 4, 512, 1024, 1)])
def test_dkv_splits_one_group_where_keys_outnumber_queries(hq, hkv, sq, sk,
                                                           splits):
    assert flash_attention_bwd_cuda.dkv_splits(hq, hkv, sq, sk) == splits


def test_c_interface_carries_the_offset():
    """The kernels' C interface carries the offset: the forward takes B,
    Sq, Sk and q_off ahead of the heads, the backward the same after
    n_split."""
    sig = build._SIGNATURES
    assert len(sig["rt_flash_attention_fwd"]) == 16
    assert len(sig["rt_flash_attention_bwd"]) == 23
