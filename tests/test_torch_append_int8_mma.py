"""The arithmetic of the append kernel's int8 tensor-core arm, held to the
reference.

The TPU append kernel dequantises an int8 key stream to f32
(``k.astype(f32) * ks``), takes the scores in f32 and keeps p in f32 for
P V.  The port's int8 arm for a bf16 q (``append_mma_kernel<D,
Int8Stream>`` in ``csrc/flash_append.cu``) runs on bf16 tensor cores
instead: K and V as their integers in bf16 (exact), each score scaled by
its key's k scale after the product, and w = p times the key's v scale
split into two bf16 terms, hi + lo, for two P V products.
``ref.append_int8_mma_ref`` is a plain model of that arithmetic.  Here,
on the CPU where the CUDA kernel cannot run:

- the model lies within ``chip_smoke.py``'s int8 tolerance (bf16 two
  ulps, atol 1e-5, no rounding term) of the Pallas append kernel in
  interpret mode, on seeded numpy inputs: a linear prefix, a ring, a
  window of 16 keys and a ragged batch (a chunk of 48 rows, one row's
  prefix partly unwritten);
- a negative control: the same model without the lo term, p * v scale
  rounded once to bf16 as a bf16 P V product would, fails that tolerance
  already among the outputs of magnitude 0.05 and more, so the check sees
  the term;
- an f32 q over an int8 stream keeps the SIMT arm, counted apart
  (``flash_append_int8_f32``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import dispatch, kv_quant, ref  # noqa: E402
from repro_torch.models.attention import _cache_positions  # noqa: E402

# chip_smoke.py's bf16 tolerance, which its int8 append check applies
BF16_TOL = (2.0 ** -6, 1e-5)
HQ, HKV = 8, 2
# (label, batch, chunk rows, pos0, window, ring rows, head dim)
LAYOUTS = [("linear", 2, 64, 64, None, None, 64),
           ("ring64", 2, 64, 96, 64, 64, 64),
           ("window16", 2, 64, 128, 16, None, 128),
           ("ragged", 3, 48, 64, None, None, 64)]


def _inputs(seed, b, c, pos0, ring, d):
    """bf16 q, the int8 key stream (prefix + chunk) quantised per row and
    kv head with f32 scales, int32 kpos; the ragged layout's batch row 1
    has prefix rows 40..63 unwritten."""
    rng = np.random.default_rng(seed)
    sk = (ring or pos0) + c
    q = torch.from_numpy(rng.standard_normal((b, c, HQ, d)).astype(
        np.float32)).to(torch.bfloat16)
    (k8, ks), (v8, vs) = (kv_quant.quantize(torch.from_numpy(
        rng.standard_normal((b, sk, HKV, d)).astype(np.float32)))
        for _ in range(2))
    chunk = pos0 + np.arange(c)
    if ring is None:
        kpos = np.arange(sk)
    else:
        kpos = np.concatenate([_cache_positions(
            ring, torch.tensor(pos0 - 1), ring).numpy(), chunk])
    kpos = np.broadcast_to(kpos.astype(np.int32), (b, sk)).copy()
    if b == 3:
        kpos[1, 40:pos0] = -1
    return q, k8, v8, ks, vs, torch.from_numpy(kpos)


def _pallas(q, k8, v8, ks, vs, kpos, pos0, window, linear):
    got = jax_flash.flash_attention_append(
        jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(k8.numpy()),
        jnp.asarray(v8.numpy()), jnp.asarray(kpos.numpy()), pos0=pos0,
        window=window, kpos_linear=linear, interpret=True,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    return torch.from_numpy(np.array(got.astype(jnp.float32)))


def _use(got, want, floor=0.0):
    """Worst share of atol + rtol * |want| (<= 1 passes) over the elements
    with |want| >= floor."""
    got, want = got.float(), want.float()
    ratio = (got - want).abs() / (BF16_TOL[1] + BF16_TOL[0] * want.abs())
    return float(ratio[want.abs() >= floor].max())


@pytest.mark.parametrize("label,b,c,pos0,window,ring,d", LAYOUTS)
def test_int8_mma_model_matches_pallas(label, b, c, pos0, window, ring, d):
    q, k8, v8, ks, vs, kpos = _inputs(40 + d + c, b, c, pos0, ring, d)
    want = _pallas(q, k8, v8, ks, vs, kpos, pos0, window, ring is None)
    got = ref.append_int8_mma_ref(q, k8, v8, ks, vs, kpos, pos0=pos0,
                                  window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    use = _use(got, want)
    assert use <= 1.0, f"{label}: {use:.3f} of its tolerance"
    # the plain version the card holds the arm to agrees as well
    plain = ref.flash_attention_append_quant_ref(q, k8, v8, ks, vs, kpos,
                                                 pos0=pos0, window=window)
    assert _use(plain, want) <= 1.0


@pytest.mark.parametrize("label,b,c,pos0,window,ring,d", LAYOUTS)
def test_hi_only_model_fails_the_tolerance(label, b, c, pos0, window, ring,
                                           d):
    q, k8, v8, ks, vs, kpos = _inputs(40 + d + c, b, c, pos0, ring, d)
    want = _pallas(q, k8, v8, ks, vs, kpos, pos0, window, ring is None)
    hi = ref.append_int8_mma_ref(q, k8, v8, ks, vs, kpos, pos0=pos0,
                                 window=window, split=False)
    # already among the outputs of 0.05 and more, where the tolerance is
    # two ulps of the output and not its atol
    use = _use(hi, want, floor=0.05)
    assert use > 1.0, f"{label}: hi only passed ({use:.3f})"


def test_int8_f32_arm_counted_apart():
    assert {"flash_append_int8", "flash_append_int8_f32"} <= \
        set(dispatch.launch_counts())
    q, k8, v8, ks, vs, kpos = _inputs(1, 2, 64, 64, None, 64)
    dispatch.reset_launch_counts()
    # CPU tensors take the plain version: no arm counts a launch
    for qq in (q, q.float()):
        out = dispatch.flash_attention_append(qq, k8, v8, kpos, pos0=64,
                                              kpos_linear=True, k_scale=ks,
                                              v_scale=vs)
        assert out.dtype == qq.dtype
    counts = dispatch.launch_counts()
    assert counts["flash_append_int8"] == counts["flash_append_int8_f32"] \
        == 0
