"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``.

Every case runs under both counter layouts of jax's
``jax_threefry_partitionable`` flag (True from jax 0.5 on, False before),
set for the jax call and restored after it, the port's layout chosen by
its ``partitionable`` argument.  Integer draws, ``uniform`` and
``bernoulli`` agree exactly.  ``categorical`` over 64,000 logits agrees
exactly in every row whose top-2 score margin exceeds 1e-5; in these cases
no row falls below that margin (the test counts them and requires none).
``truncated_normal`` agrees within 4 f32 ulps of each value: torch's
``log1p`` differs from XLA's in the last place on some inputs.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

LAYOUTS = [pytest.param(True, id="partitionable"),
           pytest.param(False, id="original")]
SEEDS = (0, 7, 2**31 - 1)
SHAPES = ((1,), (5,), (3, 7), (4, 1000))


@contextlib.contextmanager
def layout(partitionable):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", (0, 1, 42, 2**31 - 1, 2**32 + 5, -1))
def test_key(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _words(jax.random.key(seed)))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(part, seed):
    data = np.array([0, 1, 5, 2**31 - 1, 2**31 + 9, 2**32 - 1], np.uint32)
    with layout(part):
        want = _words(jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(seed), jnp.asarray(data)))
        nested = _words(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(seed), 3), 11))
    k = prng.key(seed)
    np.testing.assert_array_equal(
        prng.fold_in(k, torch.from_numpy(data.astype(np.int64))).numpy(),
        want)
    np.testing.assert_array_equal(prng.fold_in(prng.fold_in(k, 3), 11)
                                  .numpy(), nested)
    # a batch of keys folds one datum each, as vmap(fold_in)
    keys = prng.fold_in(k, torch.arange(4))
    with layout(part):
        wj = _words(jax.vmap(jax.random.fold_in)(
            jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(seed),
                                                    jnp.arange(4)),
            jnp.arange(4) + 100))
    np.testing.assert_array_equal(
        prng.fold_in(keys, torch.arange(4) + 100).numpy(), wj)


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("num", (2, 3, 37))
def test_split(part, num):
    for seed in SEEDS:
        with layout(part):
            want = _words(jax.random.split(jax.random.key(seed), num))
        got = prng.split(prng.key(seed), num, partitionable=part)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits(part, shape):
    for seed in SEEDS:
        with layout(part):
            want = np.asarray(jax.random.bits(jax.random.key(seed), shape))
        got = prng.bits(prng.key(seed), shape, partitionable=part)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(part, shape):
    for seed in SEEDS:
        for lo, hi in ((0.0, 1.0), (-0.9544997, 0.9544997), (-3.0, 5.5)):
            with layout(part):
                want = np.asarray(jax.random.uniform(
                    jax.random.key(seed), shape, minval=lo, maxval=hi))
            got = prng.uniform(prng.key(seed), shape, lo, hi,
                               partitionable=part).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bernoulli(part, shape):
    for seed in SEEDS:
        with layout(part):
            want = np.asarray(jax.random.bernoulli(jax.random.key(seed), 0.3,
                                                   shape))
        got = prng.bernoulli(prng.key(seed), 0.3, shape, partitionable=part)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint(part, shape):
    for seed in SEEDS:
        for lo, hi in ((0, 64000), (-5, 2**31 - 1), (3, 4), (7, 2)):
            with layout(part):
                want = np.asarray(jax.random.randint(jax.random.key(seed),
                                                     shape, lo, hi))
            got = prng.randint(prng.key(seed), shape, lo, hi,
                               partitionable=part)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(part, seed):
    """16 rows of 64,000 logits, one key a row as the engine folds them:
    the token agrees in every row whose top-2 margin of gumbel + logits
    exceeds 1e-5, and no row falls below it."""
    rows, vocab = 16, 64000
    rng = np.random.default_rng(seed % 1000)
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    with layout(part):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.key(seed), jnp.arange(rows))
        want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
        scores = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (vocab,)))(keys)) + logits
    top2 = np.sort(scores, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    keys_t = prng.fold_in(prng.key(seed), torch.arange(rows))
    got = prng.categorical(keys_t, torch.from_numpy(logits),
                           partitionable=part).numpy()
    decided = margin > 1e-5
    assert int((~decided).sum()) == 0, margin.min()
    np.testing.assert_array_equal(got[decided], want[decided])
    # one key over a (V,) row: noise of the row's shape
    with layout(part):
        one = int(jax.random.categorical(jax.random.key(seed), logits[0]))
    assert int(prng.categorical(prng.key(seed), torch.from_numpy(logits[0]),
                                partitionable=part)) == one


def _assert_ulps(got, want, n):
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))
    assert float(ulps.max()) <= n, float(ulps.max())


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", ((7,), (64, 33), (256, 512)))
def test_truncated_normal(part, shape):
    for seed in SEEDS:
        with layout(part):
            want = np.asarray(jax.random.truncated_normal(
                jax.random.key(seed), -2.0, 2.0, shape))
        got = prng.truncated_normal(prng.key(seed), -2.0, 2.0, shape,
                                    partitionable=part).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        assert np.all(np.abs(got) < 2.0)
        _assert_ulps(got, want, 4)


@pytest.mark.parametrize("part", LAYOUTS)
def test_truncated_normal_in_chunks(part, monkeypatch):
    """A draw hashed a chunk of flat counters at a time (an odd size, so
    the original layout's padded pair falls inside a chunk) equals the
    whole draw, and ``scale``/``dtype`` are the f32 product, then cast."""
    shape = (37, 29)
    whole = prng.truncated_normal(prng.key(3), -2.0, 2.0, shape,
                                  partitionable=part)
    monkeypatch.setattr(prng, "CHUNK", 100)
    chunked = prng.truncated_normal(prng.key(3), -2.0, 2.0, shape,
                                    partitionable=part)
    assert torch.equal(chunked, whole)
    scaled = prng.truncated_normal(prng.key(3), -2.0, 2.0, shape,
                                   partitionable=part, scale=0.02,
                                   dtype=torch.bfloat16)
    want = (whole * torch.tensor(0.02, dtype=torch.float32)).bfloat16()
    assert scaled.dtype == torch.bfloat16 and torch.equal(scaled, want)


def test_erfinv_matches_xla():
    x = np.linspace(-0.999, 0.999, 20001, dtype=np.float32)
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    _assert_ulps(prng.erfinv(torch.from_numpy(x)).numpy(), want, 4)
    edge = prng.erfinv(torch.tensor([1.0, -1.0]))
    assert torch.equal(edge, torch.tensor([1.0, -1.0])
                       * float(np.finfo(np.float32).max))


def test_gumbel_close_to_jax():
    """Gumbel noise differs from jax's only by the last-place rounding of
    the logarithms: below 1e-5 absolute over 64,000 draws."""
    for part in (True, False):
        with layout(part):
            want = np.asarray(jax.random.gumbel(jax.random.key(9), (64000,)))
        got = prng.gumbel(prng.key(9), (64000,), partitionable=part).numpy()
        assert float(np.abs(got - want).max()) < 1e-5


def test_original_layout_refuses_huge_draws():
    with pytest.raises(NotImplementedError, match="original"):
        prng._bits32_at(prng.key(0), torch.arange(2), 2**32,
                      partitionable=False)
