"""The bf16 rounding tolerance of the flash kernels, held to the reference.

The TPU kernels round p (forward; dv in the backward) and ds (dq, dk) to
bf16 before their products, and so do the bf16 (tensor-core) arms of the
port's CUDA flash kernels; the port's plain versions keep them in f32.
``chip_smoke.py`` holds those arms to the plain versions within the bf16
tolerance plus ``ref.ROUND_TOL`` times ``ref.flash_round_scale``.  Here,
on the CPU where the CUDA kernels cannot run:

- the JAX Pallas kernels in interpret mode, fed bf16 inputs made with
  numpy from a seed, round as the bf16 arms do: their o, dq, dk and dv lie
  within that tolerance of the port's f32 plain versions, and their lse
  within the f32 tolerance.  The tolerance admits the reference's own
  rounding;
- a negative control: the same check rejects a plain computation whose
  causal mask is shifted by one key, and one with a key dropped, at a
  window of 16 keys, and it does so already on the first query rows.  The
  added term cannot hide a masking error.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import flash_attention_bwd as jax_flash_bwd  # noqa: E402
from repro_torch.kernels import (build, dispatch,  # noqa: E402
                                 flash_attention_bwd_cuda, ref)

# chip_smoke.py's tolerances: bf16 two ulps (rtol 2**-6) with atol 1e-5;
# f32 rtol = atol = 1e-5
BF16_TOL = (2.0 ** -6, 1e-5)
F32_TOL = (1e-5, 1e-5)

B, S, HQ, HKV = 2, 256, 8, 2
CASES = [(d, window) for d in (64, 128) for window in (None, 16)]


def _inputs(seed, d):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, HQ, d), (B, S, HKV, d), (B, S, HKV, d), (B, S, HQ, d))
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _use(got, want, tol, round_abs=None):
    """Worst element's share of its tolerance, atol + rtol * |want| (+
    ROUND_TOL * round_abs); <= 1 passes.  Also per query row (dim 1)."""
    got = got.float() if torch.is_tensor(got) else \
        torch.from_numpy(np.array(got, np.float32))
    want = want.float()
    bound = tol[1] + tol[0] * want.abs()
    if round_abs is not None:
        bound = bound + ref.ROUND_TOL * round_abs
    ratio = (got - want).abs() / bound
    return float(ratio.max()), ratio.transpose(0, 1).reshape(
        ratio.shape[1], -1).amax(dim=1)


@pytest.fixture(scope="module")
def pallas_vs_plain():
    """Per case: the Pallas kernels' bf16 outputs, the port's plain
    outputs and the rounding scales, on the same bf16 inputs."""
    out = {}
    for i, (d, window) in enumerate(CASES):
        q, k, v, do = _inputs(10 + i, d)
        qt, kt, vt, dot = (_bf16(a) for a in (q, k, v, do))
        o, lse = ref.flash_attention_ref(qt, kt, vt, causal=True,
                                         window=window)
        plain_bwd = ref.flash_attention_bwd_ref(qt, kt, vt, o, lse, dot,
                                                causal=True, window=window)
        scales = ref.flash_round_scale(qt, kt, vt, o, lse, dot, True,
                                       window)
        jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16)
                           for a in (q, k, v, do))
        jo, jlse = jax_flash.flash_attention_fwd(
            jq, jk, jv, causal=True, window=window, block_q=128,
            block_k=128, save_residuals=True, interpret=True)
        # the backward from the same o and lse on both sides
        jbwd = jax_flash_bwd.flash_attention_bwd(
            jq, jk, jv, jnp.asarray(o.float().numpy(), jnp.bfloat16),
            jnp.asarray(lse.numpy()), jdo, causal=True, window=window,
            block_q=128, block_k=128, interpret=True)
        out[(d, window)] = {
            "pallas": [np.asarray(t.astype(jnp.float32))
                       for t in (jo, jlse, *jbwd)],
            "plain": [o, lse, *plain_bwd], "scales": scales}
    return out


@pytest.mark.parametrize("d,window", CASES)
@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_pallas_rounding_within_round_tol(pallas_vs_plain, d, window, name):
    case = pallas_vs_plain[(d, window)]
    at = {"o": 0, "dq": 2, "dk": 3, "dv": 4}[name]
    scale = case["scales"][{"o": 0, "dq": 1, "dk": 2, "dv": 3}[name]]
    use, _ = _use(case["pallas"][at], case["plain"][at], BF16_TOL, scale)
    assert use <= 1.0, f"{name}: {use:.3f} of its tolerance"
    # the added term is needed: without it the reference's own rounding
    # of p / ds would fail the two-ulp tolerance somewhere
    assert _use(case["pallas"][at], case["plain"][at], BF16_TOL)[0] > 1.0


@pytest.mark.parametrize("d,window", CASES)
def test_pallas_lse_within_f32_tol(pallas_vs_plain, d, window):
    case = pallas_vs_plain[(d, window)]
    use, _ = _use(case["pallas"][1], case["plain"][1], F32_TOL)
    assert use <= 1.0, f"lse: {use:.3f} of its tolerance"


# ---------------------------------------------------------------------------
# negative control: a masking error is rejected
# ---------------------------------------------------------------------------

def _masked_plain(q, k, v, do, mask):
    """o, dq, dk, dv with an explicit (S, S) key mask, by the plain
    versions' f32 arithmetic (the finite NEG mask; the backward from the
    lse and the rounded o, as ``ref.flash_attention_bwd_ref``)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) * d ** -0.5
    logits = torch.where(mask[None, :, None, None, :], logits, ref.NEG)
    p = torch.exp(logits - torch.logsumexp(logits, -1, keepdim=True))
    o = torch.einsum("bshgt,bthd->bshgd", p, v.float()).to(q.dtype)
    dog = do.reshape(b, s, hkv, g, d).float()
    delta = (dog * o.float()).sum(-1, keepdim=True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float())
    ds = p * (dp - delta) * d ** -0.5
    dq = torch.einsum("bshgt,bthd->bshgd", ds, k.float())
    dk = torch.einsum("bshgt,bshgd->bthd", ds, qg)
    dv = torch.einsum("bshgt,bshgd->bthd", p, dog)
    return [o.reshape(b, s, hq, d), dq.reshape(b, s, hq, d).to(q.dtype),
            dk.to(q.dtype), dv.to(q.dtype)]


def _faulty_mask(kind, window):
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    if kind == "shifted":        # one key of the future per row
        return (j <= i + 1) & (j > i + 1 - window)
    keep = (j <= i) & (j > i - window)
    return keep & (j != i - 1)   # the key just before the query dropped


@pytest.mark.parametrize("kind", ["shifted", "dropped"])
@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_round_tol_rejects_masking_errors(kind, name):
    window = 16
    q, k, v, do = (_bf16(a) for a in _inputs(3, 64))
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                             causal=True, window=window)
    scales = ref.flash_round_scale(q, k, v, o, lse, do, True, window)
    bad = _masked_plain(q, k, v, do, _faulty_mask(kind, window))
    at = ("o", "dq", "dk", "dv").index(name)
    use, per_row = _use(bad[at], (o, dq, dk, dv)[at], BF16_TOL, scales[at])
    assert use > 1.0, f"{kind} mask passed the {name} check ({use:.3f})"
    # and the check sees it already on the first query rows (or, for dk and
    # dv, on the first key rows)
    assert float(per_row[:4].max()) > 1.0


def test_faithful_mask_passes_the_same_check():
    """The control's own plumbing: the true mask through the same
    arithmetic passes where the faulty ones fail."""
    window = 16
    q, k, v, do = (_bf16(a) for a in _inputs(3, 64))
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    want = (o, *ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                            window=window))
    scales = ref.flash_round_scale(q, k, v, o, lse, do, True, window)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    got = _masked_plain(q, k, v, do, (j <= i) & (j > i - window))
    for g, w, sc in zip(got, want, scales):
        assert _use(g, w, BF16_TOL, sc)[0] <= 1.0


# ---------------------------------------------------------------------------
# the host side of the tensor-core arms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,splits", [(32, 4, 4), (8, 2, 2), (8, 8, 1),
                                           (12, 4, 3), (6, 1, 3)])
def test_dkv_splits_two_heads_a_block(hq, hkv, splits):
    """The bf16 dkv grid splits each kv head's G q heads into groups of 2
    (of 1 where G is odd): 4 splits at Yi-6B's G = 8."""
    assert flash_attention_bwd_cuda.dkv_splits(hq, hkv) == splits
    assert (hq // hkv) % splits == 0


def test_kernel_resources_parses_ptxas():
    log = "\n".join([
        "== flash_attention.cu",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash"
        "_fwd_mma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiiif' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 246 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__14713c99"
        "_10_rmsprop_cu_66453cc214rmsprop_kernelEPKfS1_PfS2_xffff' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers"])
    assert build.kernel_resources(log) == [
        {"name": "flash_fwd_mma_kernel<128>", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 246},
        {"name": "rmsprop_kernel", "stack": 8, "spill_stores": 8,
         "spill_loads": 4, "registers": 32}]


def test_flash_arm_counters_registered():
    arms = {"flash_attention", "flash_attention_f32", "flash_attention_bwd",
            "flash_attention_bwd_f32"}
    assert arms <= set(dispatch.launch_counts())
    dispatch.reset_launch_counts()
    assert all(dispatch.launch_counts()[op] == 0 for op in arms)
