"""The bf16 rounding tolerance of the append kernel, held to the reference.

The TPU append kernel rounds p to bf16 before P V (``p.astype(v.dtype)``),
and so does the bf16 (tensor-core) arm of the port's CUDA append kernel;
the port's plain version keeps p in f32.  ``chip_smoke.py`` holds that arm
to the plain version within the bf16 tolerance plus ``ref.ROUND_TOL``
times ``ref.append_round_scale`` (sum_j p_ij |v_j|).  Here, on the CPU
where the CUDA kernel cannot run:

- the Pallas append kernel in interpret mode, fed bf16 inputs made with
  numpy from a seed (a linear prefix, a window of 16, a ring of 64 rows),
  lies within that tolerance of the port's f32 plain version, and outside
  the bf16 tolerance alone: the added term admits the reference's own
  rounding and is needed for it;
- a negative control: the same check rejects a plain computation whose
  mask is shifted by one key and one with a key dropped, at a window of
  16 keys, already on the first chunk rows;
- the SIMT float arm has its own launch counter, ``flash_append_f32``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import dispatch, flash_append_cuda, ref  # noqa: E402
from repro_torch.models.attention import _cache_positions  # noqa: E402

# chip_smoke.py's bf16 tolerance: two ulps (rtol 2**-6) with atol 1e-5
BF16_TOL = (2.0 ** -6, 1e-5)
B, C, HQ, HKV = 2, 64, 8, 2
# (label, pos0, window, ring rows)
LAYOUTS = [("linear", 64, None, None), ("window16", 128, 16, None),
           ("ring64", 96, 64, 64)]


def _inputs(seed, d, pos0, ring):
    """bf16 q, k, v and int32 kpos as attend_prefill builds them: a linear
    prefix [0, pos0) + the chunk, or a rotated ring of ``ring`` rows +
    the chunk."""
    rng = np.random.default_rng(seed)
    sk = (ring or pos0) + C
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((B, C, HQ, d), (B, sk, HKV, d), (B, sk, HKV, d)))
    chunk = pos0 + np.arange(C)
    if ring is None:
        kpos = np.arange(sk)
    else:
        kpos = np.concatenate([_cache_positions(
            ring, torch.tensor(pos0 - 1), ring).numpy(), chunk])
    kpos = np.broadcast_to(kpos.astype(np.int32), (B, sk)).copy()
    return q, k, v, kpos


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _use(got, want, round_abs=None):
    """Worst element's share of its tolerance, atol + rtol * |want| (+
    ROUND_TOL * round_abs); <= 1 passes.  Also per chunk row."""
    got = got.float() if torch.is_tensor(got) else \
        torch.from_numpy(np.array(got, np.float32))
    want = want.float()
    bound = BF16_TOL[1] + BF16_TOL[0] * want.abs()
    if round_abs is not None:
        bound = bound + ref.ROUND_TOL * round_abs
    ratio = (got - want).abs() / bound
    return float(ratio.max()), ratio.transpose(0, 1).reshape(C, -1).amax(1)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("label,pos0,window,ring", LAYOUTS)
def test_pallas_append_rounding_within_round_tol(d, label, pos0, window,
                                                 ring):
    q, k, v, kpos = _inputs(20 + d, d, pos0, ring)
    qt, kt, vt = (_bf16(a) for a in (q, k, v))
    kp = torch.from_numpy(kpos)
    plain = ref.flash_attention_append_ref(qt, kt, vt, kp, pos0=pos0,
                                           window=window)
    scale = ref.append_round_scale(qt, kt, vt, kp, pos0=pos0, window=window)
    got = jax_flash.flash_attention_append(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(kpos), pos0=pos0, window=window,
        kpos_linear=ring is None, interpret=True)
    got = np.asarray(got.astype(jnp.float32))
    use, _ = _use(got, plain, scale)
    assert use <= 1.0, f"{label}: {use:.3f} of its tolerance"
    # the added term is needed: the reference's own rounding of p fails
    # the two-ulp tolerance somewhere
    assert _use(got, plain)[0] > 1.0


def _window16():
    q, k, v, kpos = _inputs(3, 64, 128, None)
    return (*(_bf16(a) for a in (q, k, v)), torch.from_numpy(kpos))


@pytest.mark.parametrize("kind", ["shifted", "dropped"])
def test_round_tol_rejects_masking_errors(kind):
    """A mask shifted by one key (every query one position later: one key
    of the future in, the oldest key of its window out) or a key dropped
    (the key just before the chunk, for every query) fails the check
    already on the first chunk rows."""
    q, k, v, kpos = _window16()
    pos0, window = 128, 16
    want = ref.flash_attention_append_ref(q, k, v, kpos, pos0=pos0,
                                          window=window)
    scale = ref.append_round_scale(q, k, v, kpos, pos0=pos0, window=window)
    if kind == "shifted":
        bad = ref.flash_attention_append_ref(q, k, v, kpos, pos0=pos0 + 1,
                                             window=window)
    else:
        dropped = kpos.clone()
        dropped[:, pos0 - 1] = -1
        bad = ref.flash_attention_append_ref(q, k, v, dropped, pos0=pos0,
                                             window=window)
    use, per_row = _use(bad, want, scale)
    assert use > 1.0, f"{kind} mask passed the check ({use:.3f})"
    assert float(per_row[:4].max()) > 1.0


def test_faithful_mask_passes_the_same_check():
    """The control's own plumbing: the true mask through the same f32
    arithmetic, rounded to bf16 once, passes where the faulty ones fail."""
    q, k, v, kpos = _window16()
    want = ref.flash_attention_append_ref(q, k, v, kpos, pos0=128, window=16)
    scale = ref.append_round_scale(q, k, v, kpos, pos0=128, window=16)
    got = ref.flash_attention_append_ref(q.float(), k.float(), v.float(),
                                         kpos, pos0=128, window=16)
    assert _use(got.to(torch.bfloat16), want, scale)[0] <= 1.0


def test_append_arm_counters_registered():
    arms = {"flash_append", "flash_append_f32", "flash_append_int8",
            "flash_append_int8_f32"}
    assert arms <= set(dispatch.launch_counts())
    q, k, v, kpos = _window16()
    dispatch.reset_launch_counts()
    # CPU tensors take the plain version: no arm counts a launch
    dispatch.flash_attention_append(q, k, v, kpos, pos0=128, window=16,
                                    kpos_linear=True)
    dispatch.flash_attention_append(q.float(), k.float(), v.float(), kpos,
                                    pos0=128, window=16)
    assert all(dispatch.launch_counts()[op] == 0 for op in arms)
    assert flash_append_cuda.f32_launches == 0
