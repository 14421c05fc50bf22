"""The RL loop's random draws and environments in the port against the
JAX package, on the CPU.

``prng``'s batched ``split``, ``normal``, ``choice`` (both arms) and the
draws the runner makes one row per worker key (``uniform``, ``randint``
with a bound per key, ``bernoulli``, ``categorical``) against
``jax.vmap`` of ``jax.random``, under both counter layouts: integers,
uniforms and choices exactly; ``normal`` within 4 f32 ulps (it inherits
the port's erfinv); ``categorical`` exactly where its top-2 margin exceeds
1e-5 (the Gumbel noise differs by ~1e-6).  Then every environment over 30
steps of a fixed action stream from the same keys, batched over 4 workers
against ``vmap`` of the JAX env: Catch and GridMaze states, observations,
rewards and dones exactly (GridMaze's portal, start, respawn and apple
draws qualified by their margin, which the test requires above 1e-5), the
continuous ones within 1e-5.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import envs as jax_envs  # noqa: E402
from repro.envs.api import flatten_obs as jax_flatten  # noqa: E402
from repro_torch import envs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.envs.api import flatten_obs  # noqa: E402

LAYOUTS = [pytest.param(True, id="partitionable"),
           pytest.param(False, id="original")]
MARGIN = 1e-5
K = 4


@contextlib.contextmanager
def layout(partitionable):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The RL loop is thousands of ops on tensors of a few workers, which
    intra-op threads only slow (several test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _keys(seed, n=5):
    ks = jax.random.split(jax.random.key(seed), n)
    return ks, torch.from_numpy(_words(ks))


def _ulps(got, want):
    got = np.atleast_1d(np.asarray(got, np.float32))
    want = np.atleast_1d(np.asarray(want, np.float32))
    spacing = np.spacing(np.abs(want))
    spacing[spacing == 0] = np.finfo(np.float32).tiny
    return float(np.max(np.abs(got.astype(np.float64) - want) / spacing))


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("num", (2, 3, 8))
def test_split_of_a_batch_of_keys(part, num):
    with layout(part):
        ks, kt = _keys(3)
        want = _words(jax.vmap(lambda k: jax.random.split(k, num))(ks))
        nested = _words(jax.vmap(jax.vmap(jax.random.split))(
            jax.vmap(lambda k: jax.random.split(k, 3))(ks)))
    got = prng.split(kt, num, partitionable=part)
    assert got.shape == (5, num, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        prng.split(prng.split(kt, 3, partitionable=part),
                   partitionable=part).numpy(), nested)


@pytest.mark.parametrize("part", LAYOUTS)
@pytest.mark.parametrize("shape", ((), (1,), (3,), (2, 5)))
def test_normal(part, shape):
    with layout(part):
        ks, kt = _keys(11)
        want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(ks))
        one = np.asarray(jax.random.normal(ks[0], shape))
    got = prng.normal(kt, shape, partitionable=part)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= 4
    assert _ulps(prng.normal(kt[0], shape, partitionable=part).numpy(),
                 one) <= 4


@pytest.mark.parametrize("part", LAYOUTS)
def test_choice_with_replacement(part):
    p = np.array([0.4, 0.3, 0.3], np.float32)
    with layout(part):
        ks, kt = _keys(5, 6)
        want = np.asarray(jax.vmap(lambda k: jax.random.choice(
            k, 3, (16,), p=jnp.asarray(p)))(ks))
        one = np.asarray(jax.random.choice(ks[0], 3, (7,), p=jnp.asarray(p)))
    np.testing.assert_array_equal(
        prng.choice(kt, 3, (16,), p=torch.from_numpy(p),
                    partitionable=part).numpy(), want)
    np.testing.assert_array_equal(
        prng.choice(kt[0], 3, (7,), p=torch.from_numpy(p),
                    partitionable=part).numpy(), one)


@pytest.mark.parametrize("part", LAYOUTS)
def test_choice_without_replacement(part):
    """The Gumbel top-k over log p; zero probabilities (log 0 = -inf) are
    never chosen."""
    rng = np.random.default_rng(0)
    p = rng.random((6, 81)).astype(np.float32)
    p[rng.random((6, 81)) < 0.3] = 0.0
    p /= p.sum(1, keepdims=True)
    with layout(part):
        ks, kt = _keys(9, 6)
        want = np.asarray(jax.vmap(lambda k, q: jax.random.choice(
            k, 81, (5,), replace=False, p=q))(ks, jnp.asarray(p)))
    with prng.margins() as log:
        got = prng.choice(kt, 81, (5,), replace=False,
                          p=torch.from_numpy(p), partitionable=part).numpy()
    assert log.smallest() > MARGIN
    np.testing.assert_array_equal(got, want)
    assert (np.take_along_axis(p, got, 1) > 0).all()


@pytest.mark.parametrize("part", LAYOUTS)
def test_draws_one_row_per_key(part):
    """uniform (with bounds), randint with one bound per key (the replay
    buffers' fill level), bernoulli and categorical over (K, 2) keys, as
    ``jax.vmap``."""
    bounds = np.array([1, 5, 64, 3, 1000])
    logits = np.random.default_rng(1).standard_normal((5, 81)) \
        .astype(np.float32)
    with layout(part):
        ks, kt = _keys(13)
        v = jax.vmap
        want = {
            "uniform": v(lambda k: jax.random.uniform(
                k, (2,), minval=-1, maxval=1))(ks),
            "randint": v(lambda k, m: jax.random.randint(k, (8,), 0, m))(
                ks, jnp.asarray(bounds)),
            "randint_scalar": v(lambda k: jax.random.randint(k, (), 0, 3))(
                ks),
            "bernoulli": v(lambda k: jax.random.bernoulli(k, 0.2, (9, 9)))(
                ks),
            "categorical": v(jax.random.categorical)(ks,
                                                     jnp.asarray(logits)),
        }
    got = {
        "uniform": prng.uniform(kt, (2,), -1, 1, partitionable=part),
        "randint": prng.randint(kt, (8,), 0, torch.from_numpy(bounds)[:, None],
                                partitionable=part),
        "randint_scalar": prng.randint(kt, (), 0, 3, partitionable=part),
        "bernoulli": prng.bernoulli(kt, 0.2, (9, 9), partitionable=part),
    }
    with prng.margins() as log:
        got["categorical"] = prng.categorical(kt, torch.from_numpy(logits),
                                              partitionable=part)
    assert log.smallest() > MARGIN
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)


def test_margin_log_is_scoped():
    logits = torch.zeros(3, 4)
    keys = prng.split(prng.key(0), 3)
    with prng.margins() as log:
        assert prng.logging_margins()
        prng.categorical(keys, logits)
    assert not prng.logging_margins() and len(log.gaps) == 1
    prng.categorical(keys, logits)
    assert len(log.gaps) == 1 and log.smallest() > 0


# ---------------------------------------------------------------------------
# environments
# ---------------------------------------------------------------------------

ENVS = ("catch", "gridmaze", "pendulum", "pointmass")


def _run_env(name, flat=False, steps=30):
    je, te = jax_envs.make(name), envs.make(name)
    if flat:
        je, te = jax_flatten(je), flatten_obs(te)
    ks = jax.random.split(jax.random.key(5), K)
    js, jo = jax.vmap(je.reset)(ks)
    rng = np.random.default_rng(0)
    out = []
    with prng.margins() as log:
        ts, to = te.reset(torch.from_numpy(_words(ks)))
        out.append((list(ts) + [to], list(js) + [jo]))
        for t in range(steps):
            if te.continuous:
                a = rng.uniform(-1.5, 1.5, (K, te.n_actions)) \
                    .astype(np.float32)
            else:
                a = rng.integers(0, te.n_actions, K)
            ks = jax.random.split(jax.random.key(100 + t), K)
            js, jo, jr, jd = jax.vmap(je.step)(js, jnp.asarray(a), ks)
            ts, to, tr, td = te.step(ts, torch.from_numpy(a),
                                     torch.from_numpy(_words(ks)))
            out.append((list(ts) + [to, tr, td], list(js) + [jo, jr, jd]))
    return te, out, log.smallest()


@pytest.mark.parametrize("name", ENVS)
def test_env_matches_jax(name):
    te, out, margin = _run_env(name)
    assert margin > MARGIN, f"{name}: an undecided draw (margin {margin})"
    assert te.obs_shape == jax_envs.make(name).obs_shape
    for t, (got, want) in enumerate(out):
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, (name, t, g.shape, w.shape)
            if te.continuous:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} step {t}")
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"{name} step {t}")


@pytest.mark.parametrize("name", ("catch", "gridmaze"))
def test_flattened_env_matches_jax(name):
    te, out, margin = _run_env(name, flat=True, steps=12)
    assert margin > MARGIN
    assert te.obs_shape == jax_flatten(jax_envs.make(name)).obs_shape
    for t, (got, want) in enumerate(out):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(w).astype(
                                              g.numpy().dtype),
                                          err_msg=f"{name} step {t}")


def test_episodes_end_and_restart():
    """Catch ends every rows - 1 steps with a +-1 reward and restarts;
    every GridMaze episode lasts its episode_len."""
    env = envs.catch.make(6, 3)
    keys = prng.split(prng.key(0), 3)
    st, _ = env.reset(keys)
    dones, rewards = [], []
    for t in range(10):
        st, _, r, d = env.step(st, torch.ones(3, dtype=torch.int64),
                               prng.split(prng.key(t + 1), 3))
        dones.append(d)
        rewards.append(r)
    dones = torch.stack(dones)
    assert dones[4].all() and dones[9].all() and dones.sum() == 6
    assert set(torch.stack(rewards)[dones].tolist()) <= {1.0, -1.0}
    assert (st.t == 0).all() or (st.ball[:, 0] < 6).all()
    maze = envs.gridmaze.make(size=5, episode_len=3)
    st, _ = maze.reset(prng.split(prng.key(0), 2))
    done_at = []
    for t in range(6):
        st, _, _, d = maze.step(st, torch.zeros(2, dtype=torch.int64),
                                prng.split(prng.key(t), 2))
        done_at.append(bool(d.all()))
    assert done_at == [False, False, True, False, False, True]


def test_registry_matches_jax():
    assert set(envs.REGISTRY) == set(jax_envs.REGISTRY)
    for name in envs.REGISTRY:
        t, j = envs.make(name), jax_envs.make(name)
        assert (t.name, t.obs_shape, t.n_actions, t.continuous,
                t.max_episode_len) == (j.name, j.obs_shape, j.n_actions,
                                       j.continuous, j.max_episode_len)
    from repro_torch.envs import token_mdp
    assert hasattr(token_mdp, "TokenMDP")
