"""The paper's networks, the four algorithms, exploration and rollouts in
the port against the JAX package, on the CPU.

Initial weights from one key within 4 f32 ulps (``prng.truncated_normal``;
biases exactly zero).  Every algorithm's segment loss and its metrics
(rtol 1e-5) and gradients (max |diff| <= 1e-4 of each leaf's largest
|g_jax|: the two frameworks sum in different orders) on the same
trajectory, made with numpy from a seed, with the JAX weights moved over
by ``bridge.agent_params_from_jax``: the MLP agent with and without its
LSTM, the continuous (Gaussian) agent, and the conv trunk at 36 x 36
(conv2's output 3 x 3, so the flatten order is tested) with and without
the LSTM.  The batched ``act`` against ``vmap`` of the JAX act, the
exploration schedule, and a rollout segment of 4 workers against
``vmap(rollout_segment)``: actions identical where their decision margin
(``prng.margins``) exceeds 1e-5, which the tests require.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.func import grad  # noqa: E402

from repro.core import agents as jax_agents  # noqa: E402
from repro.core import exploration as jax_expl  # noqa: E402
from repro.core import rollout as jax_rollout  # noqa: E402
from repro.envs import make as jax_make  # noqa: E402
from repro.envs.api import flatten_obs as jax_flatten  # noqa: E402
from repro.models import atari as jax_nets  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import agents, exploration, prng, rollout  # noqa: E402
from repro_torch.envs import make  # noqa: E402
from repro_torch.envs.api import flatten_obs  # noqa: E402
from repro_torch.models import atari as nets  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402

MARGIN = 1e-5
T = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The RL loop is thousands of ops on tensors of a few workers, which
    intra-op threads only slow (several test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


# name -> (init kwargs, obs shape, n_actions, lstm size)
NETS = {
    "mlp": (dict(kind="mlp", obs_dim=12, hidden=16), (12,), 3, None),
    "mlp_lstm": (dict(kind="mlp", obs_dim=12, hidden=16, lstm=True,
                      lstm_size=8), (12,), 3, 8),
    "continuous": (dict(kind="mlp", obs_dim=6, hidden=16, continuous=True),
                   (6,), 2, None),
    "continuous_lstm": (dict(kind="mlp", obs_dim=6, hidden=16, lstm=True,
                             lstm_size=8, continuous=True), (6,), 2, 8),
    "conv": (dict(kind="conv", input_hw=36, in_channels=2), (36, 36, 2), 3,
             None),
    "conv_lstm": (dict(kind="conv", input_hw=36, in_channels=2, lstm=True),
                  (36, 36, 2), 3, 256),
}


def _init(lib, net, seed):
    kw, obs_shape, n_actions, _ = NETS[net]
    kw = dict(kw)
    kind = kw.pop("kind")
    obs_dim = kw.pop("obs_dim", None)
    if lib == "jax":
        key = jax.random.key(seed)
        if kind == "mlp":
            return jax_nets.init_mlp_agent_params(key, obs_dim, n_actions,
                                                  **kw)
        return jax_nets.init_atari_params(key, n_actions, **kw)
    key = prng.key(seed)
    if kind == "mlp":
        return nets.init_mlp_agent_params(key, obs_dim, n_actions,
                                          device="cpu", **kw)
    return nets.init_atari_params(key, n_actions, device="cpu", **kw)


@pytest.mark.parametrize("net", list(NETS) + ["atari84"])
def test_init_matches_jax(net):
    if net == "atari84":
        want = _np(jax_nets.init_atari_params(jax.random.key(4), 6))
        got = nets.init_atari_params(prng.key(4), 6, device="cpu")
    else:
        want, got = _np(_init("jax", net, 4)), _init("torch", net, 4)
    want, got = flatten(want), flatten(got)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, path
        if path.endswith(".b"):
            assert (g == 0).all() and (w == 0).all()
            continue
        spacing = np.spacing(np.abs(w))
        assert np.max(np.abs(g.astype(np.float64) - w) / spacing) <= 4, path


def _traj(net, seed, continuous):
    """One worker's segment: obs (T+1, ...), actions, rewards, dones (one
    episode end inside), and a segment-start LSTM state."""
    _, obs_shape, n_actions, lstm = NETS[net]
    rng = np.random.default_rng(seed)
    tr = {"obs": rng.random((T + 1,) + obs_shape).astype(np.float32),
          "rewards": rng.standard_normal(T).astype(np.float32),
          "dones": np.array([False, False, True, False, False])}
    if continuous:
        tr["actions"] = rng.standard_normal((T, n_actions)) \
            .astype(np.float32)
    else:
        tr["actions"] = rng.integers(0, n_actions, T).astype(np.int32)
    if lstm:
        tr["net_state"] = tuple(0.5 * rng.standard_normal((1, lstm))
                                .astype(np.float32) for _ in range(2))
    return tr


ALGOS = {"a3c": dict(name="a3c"),
         "a3c_gae": dict(name="a3c", gae_lambda=0.95),
         "one_step_q": dict(name="one_step_q"),
         "one_step_sarsa": dict(name="one_step_sarsa"),
         "n_step_q": dict(name="n_step_q")}
CASES = [(n, a) for n in ("mlp", "mlp_lstm", "conv", "conv_lstm")
         for a in ALGOS] + [(n, a) for n in ("continuous", "continuous_lstm")
                            for a in ("a3c", "a3c_gae")]


def _algos(algo, continuous):
    kw = dict(ALGOS[algo])
    name = kw.pop("name")
    if continuous:
        kw["continuous"] = True
    return (jax_agents.ALGORITHMS[name](**kw),
            agents.ALGORITHMS[name](**kw))


@pytest.mark.parametrize("net,algo", CASES)
def test_segment_loss_and_grads_match_jax(net, algo):
    continuous = net.startswith("continuous")
    ja, ta = _algos(algo, continuous)
    pj, tj = _init("jax", net, 0), _init("jax", net, 1)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    tt = bridge.agent_params_from_jax(_np(tj), "cpu")
    tr = _traj(net, 3, continuous)
    trj = jax.tree.map(jnp.asarray, tr)
    trt = {k: (tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple)
               else torch.from_numpy(v)) for k, v in tr.items()}
    (lj, mj), gj = jax.value_and_grad(
        lambda p: ja.segment_loss(p, tj, trj), has_aux=True)(pj)
    gt, mt = grad(lambda p: ta.segment_loss(p, tt, trt), has_aux=True)(pt)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-5)
    gj, gt = flatten(_np(gj)), flatten(gt)
    assert set(gj) == set(gt)
    for path, w in gj.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(gt[path].numpy() - w).max())
        assert err <= 1e-4 * scale, (path, err, scale)


ACT_CASES = [("mlp", "a3c"), ("mlp_lstm", "a3c"), ("continuous", "a3c"),
             ("mlp", "one_step_q"), ("conv_lstm", "n_step_q")]


@pytest.mark.parametrize("net,algo", ACT_CASES)
def test_batched_act_matches_vmapped_jax(net, algo):
    continuous = net == "continuous"
    ja, ta = _algos(algo, continuous)
    pj = _init("jax", net, 0)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    _, obs_shape, _, lstm = NETS[net]
    k = 6
    rng = np.random.default_rng(2)
    obs = rng.random((k,) + obs_shape).astype(np.float32)
    eps = np.array([1.0, 0.5, 0.1, 0.01, 0.3, 0.0], np.float32)
    ks = jax.random.split(jax.random.key(8), k)
    ns_j, ns_t = None, None
    if lstm:
        ns = tuple(rng.standard_normal((k, 1, lstm)).astype(np.float32)
                   for _ in range(2))
        ns_j = tuple(jnp.asarray(x) for x in ns)
        ns_t = tuple(torch.from_numpy(x) for x in ns)
    aj, nsj = jax.vmap(ja.act, in_axes=(None, 0, 0 if lstm else None, 0, 0))(
        pj, jnp.asarray(obs), ns_j, ks, jnp.asarray(eps))
    with prng.margins() as log:
        at, nst = ta.act(pt, torch.from_numpy(obs), ns_t,
                         torch.from_numpy(_words(ks)), torch.from_numpy(eps))
    if continuous:
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                                   atol=1e-6)
    else:
        assert log.smallest() > MARGIN
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    if lstm:
        for a, b in zip(nst, nsj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_exploration_matches_jax():
    for seed in range(4):
        np.testing.assert_array_equal(
            exploration.sample_eps_final(prng.key(seed), 16).numpy(),
            np.asarray(jax_expl.sample_eps_final(jax.random.key(seed), 16)))
    finals = exploration.sample_eps_final(prng.key(0), 16)
    for frame in (0, 1, 999, 25_000, 49_999, 50_000, 10**6):
        np.testing.assert_array_equal(
            exploration.eps_at(finals, frame, 50_000).numpy(),
            np.asarray(jax_expl.eps_at(jnp.asarray(finals.numpy()),
                                       jnp.asarray(frame, jnp.int32),
                                       50_000)))
    q = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    eps = np.linspace(0, 1, 32).astype(np.float32)
    ks = jax.random.split(jax.random.key(3), 32)
    want = jax.vmap(jax_expl.eps_greedy)(ks, jnp.asarray(q), jnp.asarray(eps))
    with prng.margins() as log:
        got = exploration.eps_greedy(torch.from_numpy(_words(ks)),
                                     torch.from_numpy(q),
                                     torch.from_numpy(eps))
    assert log.smallest() > MARGIN
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lstm", [False, True])
def test_rollout_segment_matches_jax(lstm):
    """4 workers of flattened Catch, A3C with the MLP agent (and its
    LSTM): two segments of t_max 5, an episode end inside the second."""
    je, te = jax_flatten(jax_make("catch")), flatten_obs(make("catch"))
    kw = dict(hidden=16, lstm=lstm, lstm_size=8)
    pj = jax_nets.init_mlp_agent_params(jax.random.key(0), 50, 3, **kw)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    ja, ta = jax_agents.make_a3c(), agents.make_a3c()
    ns0_j = jax_nets.init_lstm_state(1, 8) if lstm else None
    ns0_t = nets.init_lstm_state(1, 8, "cpu") if lstm else None
    ks = jax.random.split(jax.random.key(1), 4)
    wj = jax.vmap(lambda k: jax_rollout.init_worker(je, k, ns0_j))(ks)
    wt = rollout.init_worker(te, torch.from_numpy(_words(ks)), ns0_t)
    seg = jax.vmap(lambda w: jax_rollout.rollout_segment(
        lambda o, n, k: ja.act(pj, o, n, k, 0.1), je, w, T))
    with prng.margins() as log:
        for _ in range(2):
            wj, trj = seg(wj)
            wt, trt = rollout.rollout_segment(
                lambda o, n, k: ta.act(pt, o, n, k, 0.1), te, wt, T)
            for name in ("obs", "actions", "rewards", "dones"):
                np.testing.assert_array_equal(
                    trt[name].numpy(),
                    np.asarray(trj[name]).astype(trt[name].numpy().dtype),
                    err_msg=name)
            for name in ("obs", "rng", "frame", "ep_ret", "last_ep_ret"):
                np.testing.assert_array_equal(
                    wt[name].numpy(),
                    np.asarray(wj[name]).astype(wt[name].numpy().dtype)
                    if name != "rng" else _words(wj[name]), err_msg=name)
            if lstm:
                for a, b in zip(wt["net_state"], wj["net_state"]):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                               rtol=1e-5, atol=1e-6)
    assert log.smallest() > MARGIN
    assert bool(trt["dones"].any())
