"""The split decode kernel's algorithm, held to the JAX package on the CPU.

The CUDA decode kernel (``csrc/decode_attention.cu``) cuts each slot's key
range into splits of whole 64-row tiles (``split_plan``), skips the tiles
without a valid key wherever the slot holds one, and combines the splits'
(acc, m, l) in split order.  It cannot run here, so its algorithm has a
plain model, ``ref.decode_split_ref``, which ``chip_smoke.py`` also holds
the kernel to on the card.  Here:

- ``split_plan`` / ``split_tiles`` cover [0, L) exactly in whole tiles,
  with 1 <= n_split <= tiles and no empty split;
- the model equals the Pallas ``decode_attention_fwd`` and
  ``decode_attention_partials`` in interpret mode to rtol = atol = 1e-5
  (f32 sums in another order), f32 and int8 caches, over ragged per-slot
  positions, an idle slot (kpos all -1), a ring cache, ragged L (77, 300),
  G = 1 and G = 16, one tile a split, several and the plan; and per slice
  of a context-parallel cache over 1, 2 and 4 slices, each slice's
  partials and the slices combined.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import kv_quant as jax_kvq  # noqa: E402
from repro_torch.kernels import decode_attention_cuda as dec  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.attention import _cache_positions  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, D, SMS = 3, 64, 132

# (label, q heads, kv heads, cache rows, ring window)
CASES = [("G4 L256", 8, 2, 256, None), ("G1 L128", 4, 4, 128, None),
         ("G16 L128", 16, 1, 128, None), ("ragged L77", 8, 2, 77, None),
         ("ragged L300", 8, 2, 300, None), ("ring L128", 8, 2, 128, 128)]


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

def _covers(length, n, per):
    tiles = -(-length // dec.TILE)
    assert 1 <= n <= tiles and per >= 1
    # the splits [s * per, min((s + 1) * per, tiles)) tile [0, L) exactly,
    # none empty; only the last may be shorter
    assert (n - 1) * per < tiles <= n * per


@pytest.mark.parametrize("b,hkv,length,want", [
    (4, 4, 1024, (16, 1)),      # Yi-6B serving: 16 splits, 256 blocks
    (4, 4, 77, (2, 1)), (4, 4, 300, (5, 1)), (1, 1, 1024, (16, 1)),
    (64, 8, 1024, (1, 16)), (2, 2, 300, (5, 1)), (3, 2, 4096, (32, 2))])
def test_split_plan_covers_the_cache(b, hkv, length, want):
    n, per = dec.split_plan(b, hkv, length, SMS)
    assert (n, per) == want
    _covers(length, n, per)
    # at least one wave of the SMs wherever the tiles allow it
    tiles = -(-length // dec.TILE)
    assert n * b * hkv >= min(SMS, tiles * b * hkv)


@pytest.mark.parametrize("length", [1, 64, 77, 300, 1024])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8, 1000])
def test_split_tiles_forced(length, n_split):
    n, per = dec.split_tiles(length, n_split)
    _covers(length, n, per)
    assert n <= n_split


def test_split_tiles_caps_tiles_per_split():
    """A block holds the live flags of at most MAX_TILES_PER_SPLIT tiles:
    one split asked of 2048 tiles becomes two."""
    length = 2048 * dec.TILE
    assert dec.split_tiles(length, 1) == (2, dec.MAX_TILES_PER_SPLIT)
    _covers(length, *dec.split_tiles(length, 1))


# ---------------------------------------------------------------------------
# the algorithm against the Pallas kernel
# ---------------------------------------------------------------------------

def _inputs(hq, hkv, length, ring, quant, seed):
    """q, caches (int8 + scales when ``quant``), kpos, pos: ragged per-slot
    positions (a third of the cache, the last row), row 2 an idle slot
    whose kpos is all -1; a ring cache rotated at positions past L."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, length, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, length, hkv, D)).astype(np.float32)
    pos = np.array([length // 3, length - 1, 5] if ring is None
                   else [5, 300, 1000], np.int32)
    kpos = _cache_positions(length, torch.from_numpy(pos), ring).numpy()
    kpos = kpos.astype(np.int32)
    if ring is None:
        kpos[2] = -1
    scales = (None, None)
    if quant:
        (k, ks), (v, vs) = (jax_kvq.quantize(jnp.asarray(x)) for x in (k, v))
        k, v = np.array(k), np.array(v)
        scales = (np.array(ks), np.array(vs))
    return q, k, v, kpos, pos, scales


def _pallas(q, k, v, kpos, pos, scales, partials):
    fn = (jax_decode.decode_attention_partials if partials
          else jax_decode.decode_attention_fwd)
    ks, vs = scales
    out = fn(*(jnp.asarray(a) for a in (q, k, v, kpos, pos)),
             interpret=True, k_scale=None if ks is None else jnp.asarray(ks),
             v_scale=None if vs is None else jnp.asarray(vs))
    return [np.asarray(t) for t in out] if partials else np.asarray(out)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


@pytest.fixture(scope="module")
def pallas_cases():
    """Per (case, quant): the inputs and the Pallas normalised output and
    partials over the whole cache."""
    out = {}
    for i, (label, hq, hkv, length, ring) in enumerate(CASES):
        for quant in (False, True):
            args = _inputs(hq, hkv, length, ring, quant, seed=i)
            out[(label, quant)] = (args, _pallas(*args, partials=False),
                                   _pallas(*args, partials=True))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("label", [c[0] for c in CASES])
@pytest.mark.parametrize("split", ["one_tile", "two_tiles", "plan"])
def test_split_model_matches_pallas(pallas_cases, label, quant, split):
    (q, k, v, kpos, pos, (ks, vs)), want, want_parts = \
        pallas_cases[(label, quant)]
    length, hkv = k.shape[1], k.shape[2]
    per = {"one_tile": 1, "two_tiles": 2,
           "plan": dec.split_plan(B, hkv, length, SMS)[1]}[split]
    t = _torch(q, k, v, kpos, pos, ks, vs)
    got = ref.decode_split_ref(*t, tiles_per_split=per)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    parts = ref.decode_split_ref(*t, tiles_per_split=per, partials=True)
    for g, w in zip(parts, want_parts):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    if kpos[2].max() < 0:
        # the idle slot keeps the TPU semantics: m = NEG and l = L
        assert np.all(parts[1].numpy()[2] == ref.NEG)
        np.testing.assert_allclose(parts[2].numpy()[2], length, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_split_model_per_cp_slice(quant, n):
    """A context-parallel slice holds global positions over its columns:
    each slice's split partials match the Pallas partials of that slice
    (a slice past a row's pos is fully masked and visits every tile), and
    the slices combined match the Pallas decode over the whole cache."""
    q, k, v, kpos, pos, (ks, vs) = _inputs(8, 2, 256, None, quant, seed=7)
    step = 256 // n
    parts = []
    for i in range(n):
        s = slice(i * step, (i + 1) * step)
        sl = [None if a is None else a[:, s] for a in (k, v, kpos, ks, vs)]
        want = _pallas(q, sl[0], sl[1], sl[2], pos, (sl[3], sl[4]),
                       partials=True)
        per = dec.split_plan(B, 2, step, SMS)[1]
        got = ref.decode_split_ref(*_torch(q, sl[0], sl[1], sl[2], pos,
                                           sl[3], sl[4]),
                                   tiles_per_split=per, partials=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        parts.append(got)
    whole = _pallas(q, k, v, kpos, pos, (ks, vs), partials=False)
    np.testing.assert_allclose(ref.combine_partials(parts).numpy(), whole,
                               **TOL)


def test_skip_rule_drops_dead_tiles_only():
    """Row 0 (pos 85 of 256) holds valid keys in tiles 0 and 1 only: with
    one tile a split, splits 2 and 3 visit nothing and vanish, and the
    result is the plain partials over the whole cache; the idle row visits
    all 256 keys at weight 1."""
    q, k, v, kpos, pos, _ = _inputs(8, 2, 256, None, False, seed=3)
    t = _torch(q, k, v, kpos, pos)
    acc, m, l = ref.decode_split_ref(*t, tiles_per_split=1, partials=True)
    full = ref.decode_attention_partials_ref(*t)
    for got, want in zip((acc, m, l), full):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float(l[2].min()) == 256.0


def test_n_split_must_be_positive():
    q, k, v, kpos, pos, _ = _torch(*_inputs(8, 2, 128, None, False, 0)[:5],
                                   None)
    with pytest.raises(ValueError, match="n_split"):
        dec.decode_attention_fwd(q, k, v, kpos, pos, n_split=0)
    # on the CPU the plain version runs whatever the split
    np.testing.assert_allclose(
        dec.decode_attention_fwd(q, k, v, kpos, pos, n_split=3).numpy(),
        ref.decode_attention_ref(q, k, v, kpos, pos).numpy(), **TOL)
