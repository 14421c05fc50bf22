"""The asynchronous runner and the ``--mode rl`` CLI of the port against
the JAX package, on the CPU.

``make_runner`` for the four algorithms x {hogwild, sync} x {shared,
per-worker statistics} on flattened Catch (4 workers, t_max 5, the MLP
agent at hidden 32, weights bridged from JAX), 3 rounds each, with a
target interval of 40 frames so the value-based methods swap at round 2:
frames, episode returns, observations and the swap round exactly; the
per-worker final epsilons identical; actions identical (their decision
margins, ``prng.margins``, required above 1e-5); the parameters, target
networks and RMSProp statistics within 1e-5 and the round metrics within
rtol 1e-5.  Then A3C on the continuous pendulum and on GridMaze, the
paper's conv + LSTM network on 36 x 36 Catch, ``evaluate`` on one key,
the CLI against ``repro.launch.train.run_rl`` on the same arguments (its
records within rtol 1e-4), and a learning check on Catch.
"""
import argparse
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import agents as jax_agents  # noqa: E402
from repro.core import async_runner as jax_runner  # noqa: E402
from repro.envs import catch as jax_catch  # noqa: E402
from repro.envs import make as jax_make  # noqa: E402
from repro.envs.api import flatten_obs as jax_flatten  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import atari as jax_nets  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import agents, async_runner, prng  # noqa: E402
from repro_torch.envs import catch, make  # noqa: E402
from repro_torch.envs.api import flatten_obs  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import atari as nets  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402

MARGIN = 1e-5
TOL = 1e-5


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


def _max_err(got, want):
    want = flatten(_np(want))
    got = flatten(got)
    assert set(got) == set(want)
    return max(float(np.abs(got[k].numpy() - w).max())
               for k, w in want.items())


def _pair(env_name, algo_name, cfg, *, hidden=32, flat=True):
    je, te = jax_make(env_name), make(env_name)
    if flat:
        je, te = jax_flatten(je), flatten_obs(te)
    kw = {"continuous": True} if je.continuous else {}
    ja = jax_agents.ALGORITHMS[algo_name](**kw)
    ta = agents.ALGORITHMS[algo_name](**kw)
    pj = jax_nets.init_mlp_agent_params(
        jax.random.key(0), je.obs_shape[0], je.n_actions, hidden=hidden,
        continuous=je.continuous)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    jr = jax_runner.make_runner(ja, je, pj, jax_runner.RunnerConfig(**cfg))
    tr = async_runner.make_runner(ta, te, pt,
                                  async_runner.RunnerConfig(**cfg))
    return jr, tr


def _run_both(jr, tr, rounds, check_stats=False, n_workers=4, shared=True):
    (ji, jround), (ti, tround) = jr, tr
    js, ts = ji(jax.random.key(1)), ti(prng.key(1))
    np.testing.assert_array_equal(ts["eps_final"].numpy(),
                                  np.asarray(js["eps_final"]))
    swaps = []
    with prng.margins() as log:
        for r in range(rounds):
            js, jm = jround(js)
            ts, tm = tround(ts)
            assert ts["frames"] == int(js["frames"])
            assert ts["last_target_sync"] == int(js["last_target_sync"])
            swaps.append(ts["last_target_sync"])
            wt, wj = ts["workers"], js["workers"]
            np.testing.assert_array_equal(wt["frame"].numpy(),
                                          np.asarray(wj["frame"]))
            np.testing.assert_array_equal(wt["last_ep_ret"].numpy(),
                                          np.asarray(wj["last_ep_ret"]))
            np.testing.assert_allclose(wt["obs"].numpy(),
                                       np.asarray(wj["obs"]), rtol=TOL,
                                       atol=TOL)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=TOL, atol=1e-7, err_msg=k)
            assert _max_err(ts["params"], js["params"]) <= TOL
            assert _max_err(ts["target_params"], js["target_params"]) <= TOL
    assert log.smallest() > MARGIN, "an undecided action"
    if check_stats:
        want = bridge.agent_opt_state_from_jax(
            _np(js["opt_state"]), "cpu", n_workers=0 if shared else n_workers)
        got = ts["opt_state"]
        pairs = [(got, want)] if shared else list(zip(got, want))
        for g, w in pairs:
            for name in w:
                err = max(float((a - b).abs().max()) for a, b in zip(
                    flatten(g[name]).values(), flatten(w[name]).values()))
                assert err <= TOL, (name, err)
    return ts, js, swaps


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_worker"])
@pytest.mark.parametrize("mode", ["hogwild", "sync"])
@pytest.mark.parametrize("algo", ["a3c", "one_step_q", "one_step_sarsa",
                                  "n_step_q"])
def test_runner_matches_jax(algo, mode, shared):
    cfg = dict(n_workers=4, t_max=5, lr0=1e-2, total_frames=10**9,
               mode=mode, shared_stats=shared, target_interval=40,
               optimizer="shared_rmsprop" if shared else "rmsprop")
    jr, tr = _pair("catch", algo, cfg)
    ts, _, swaps = _run_both(jr, tr, 3, check_stats=True, shared=shared)
    assert swaps == [0, 40, 40]
    if algo != "a3c":
        moved = max(float((a - b).abs().max()) for a, b in zip(
            flatten(ts["target_params"]).values(),
            flatten(ts["params"]).values()))
        assert moved > 0          # the round after the swap moved params
    if not shared:
        assert len(ts["opt_state"]) == 4


@pytest.mark.parametrize("env", ["pendulum", "gridmaze"])
def test_runner_continuous_and_maze_match_jax(env):
    cfg = dict(n_workers=4, t_max=5, lr0=1e-2, total_frames=10**9)
    jr, tr = _pair(env, "a3c", cfg, hidden=16)
    _run_both(jr, tr, 3)


def test_runner_conv_lstm_matches_jax():
    """The paper's conv + LSTM network on 36 x 36 Catch (unflattened)."""
    je, te = jax_catch.make(36, 36), catch.make(36, 36)
    pj = jax_nets.init_atari_params(jax.random.key(0), 3, input_hw=36,
                                    in_channels=1, lstm=True)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    cfg = dict(n_workers=4, t_max=5, lr0=1e-2, total_frames=10**9)
    jr = jax_runner.make_runner(jax_agents.make_a3c(), je, pj,
                                jax_runner.RunnerConfig(**cfg),
                                net_state0=jax_nets.init_lstm_state(1, 256))
    tr = async_runner.make_runner(agents.make_a3c(), te, pt,
                                  async_runner.RunnerConfig(**cfg),
                                  net_state0=nets.init_lstm_state(1, 256,
                                                                  "cpu"))
    ts, js, _ = _run_both(jr, tr, 2)
    for a, b in zip(ts["workers"]["net_state"], js["workers"]["net_state"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("algo", ["a3c", "n_step_q"])
def test_evaluate_matches_jax(algo):
    je, te = jax_flatten(jax_make("catch")), flatten_obs(make("catch"))
    pj = jax_nets.init_mlp_agent_params(jax.random.key(0), 50, 3, hidden=16)
    pt = bridge.agent_params_from_jax(_np(pj), "cpu")
    ja, ta = jax_agents.ALGORITHMS[algo](), agents.ALGORITHMS[algo]()
    want = jax_runner.evaluate(ja, je, pj, jax.random.key(5), n_episodes=4,
                               max_steps=24)
    with prng.margins() as log:
        got = async_runner.evaluate(ta, te, pt, prng.key(5), n_episodes=4,
                                    max_steps=24)
    assert log.smallest() > MARGIN
    assert float(got) == float(want)


def _cli_args(**kw):
    args = dict(mode="rl", seed=0, checkpoint=None,
                optimizer="shared_rmsprop", lr=7e-3, env="catch",
                algo="a3c", workers=4, t_max=5, frames=400, hidden=64,
                runner_mode="hogwild", per_worker_stats=False,
                target_interval=2000)
    args.update(kw)
    return args


def _argv(args):
    out = []
    for k, v in args.items():
        flag = "--" + k.replace("_", "-")
        if v is None or v is False:
            continue
        out += [flag] if v is True else [flag, str(v)]
    return out


@pytest.mark.parametrize("extra", [
    {}, {"algo": "n_step_q", "runner_mode": "sync"},
    {"env": "pendulum", "per_worker_stats": True, "optimizer": "rmsprop"}],
    ids=["a3c", "n_step_q_sync", "pendulum_per_worker"])
def test_cli_matches_jax(extra, capsys):
    """``python -m repro_torch.launch.train --mode rl --device cpu`` and
    ``python -m repro.launch.train --mode rl`` on the same arguments print
    the same records: rounds and frames exactly, ep_ret and loss within
    rtol 1e-4."""
    args = _cli_args(**extra)
    want = jax_train.run_rl(argparse.Namespace(**args))["history"]
    got = train.main(_argv(args) + ["--device", "cpu"])["history"]
    out = capsys.readouterr().out
    assert out.count('"round"') == 2 * len(want)
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        assert (g["round"], g["frames"]) == (w["round"], w["frames"])
        for k in ("ep_ret", "loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"round {g['round']} {k}")


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "rl", "--frames", "40"])


def test_a3c_learns_catch():
    """A3C with 8 Hogwild workers and Shared RMSProp beats the random
    policy (-0.6) decisively on Catch: the mean return over rounds
    3400-3499 exceeds 0.3, the bar of the JAX package's test."""
    env = flatten_obs(make("catch"))
    params = nets.init_mlp_agent_params(prng.key(0), 50, 3, hidden=32,
                                        device="cpu")
    cfg = async_runner.RunnerConfig(n_workers=8, t_max=5, lr0=1e-2,
                                    total_frames=10**9, target_interval=100)
    init_state, round_fn = async_runner.make_runner(agents.make_a3c(), env,
                                                    params, cfg)
    st = init_state(prng.key(2))
    rets = []
    t0 = time.time()
    for i in range(3500):
        st, m = round_fn(st)
        if i >= 3400:
            rets.append(float(m["ep_ret"]))
    assert np.mean(rets) > 0.3, (np.mean(rets), time.time() - t0)
