"""DQN with replay, replay inside the asynchronous runner, and T3 delayed
synchronisation in the port against the JAX package, on the CPU, driven
as the JAX package's own tests drive them.

DQN on flattened Catch (hidden 16, buffer 64, batch 8, warmup 8, train
every 2, target every 16) for 40 frames; replay-async (n-step Q, 4
workers, buffer 64, replay batch 8, warmup 16) for 8 rounds: parameters,
target networks and RMSProp statistics within 1e-5, buffers, fill levels
and episode returns exactly (actions margin-qualified, ``prng.margins``
above 1e-5).  Delayed sync on reduced StableLM-1.6B (2 groups, merge
interval 3, lr 1e-3, batches from ``TokenPipeline`` on the same keys):
losses within rtol 1e-5, every group's parameters within 1e-5 of JAX's,
the groups drifting apart before the merge and identical at it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import agents as jax_agents  # noqa: E402
from repro.core import delayed_sync as jax_ds  # noqa: E402
from repro.core import dqn_replay as jax_dqn  # noqa: E402
from repro.core import replay_async as jax_ra  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxPipeline  # noqa: E402
from repro.envs import make as jax_make  # noqa: E402
from repro.envs.api import flatten_obs as jax_flatten  # noqa: E402
from repro.models import atari as jax_nets  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import agents, delayed_sync, dqn_replay  # noqa: E402
from repro_torch.core import prng, replay_async  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.envs import make  # noqa: E402
from repro_torch.envs.api import flatten_obs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402

MARGIN = 1e-5
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _max_err(got, want):
    want, got = flatten(_np(want)), flatten(got)
    assert set(got) == set(want)
    return max(float(np.abs(got[k].detach().numpy() - w).max())
               for k, w in want.items())


def _agent(hidden):
    env_j, env_t = jax_flatten(jax_make("catch")), flatten_obs(make("catch"))
    pj = jax_nets.init_mlp_agent_params(jax.random.key(0),
                                        env_j.obs_shape[0], env_j.n_actions,
                                        hidden=hidden)
    return env_j, env_t, pj, bridge.agent_params_from_jax(_np(pj), "cpu")


def _check_buffers(got, want):
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_array_equal(got[name].numpy(),
                                      w.astype(got[name].numpy().dtype),
                                      err_msg=name)


def test_dqn_matches_jax():
    env_j, env_t, pj, pt = _agent(16)
    cfg = dict(buffer_size=64, batch_size=8, warmup=8, train_every=2,
               target_interval=16)
    ji, jstep = jax_dqn.make_dqn(env_j, pj, jax_dqn.DQNConfig(**cfg))
    ti, tstep = dqn_replay.make_dqn(env_t, pt, dqn_replay.DQNConfig(**cfg))
    js, ts = ji(jax.random.key(1)), ti(prng.key(1))
    with prng.margins() as log:
        for _ in range(40):
            js, ts = jstep(js), tstep(ts)
            assert ts["frames"] == int(js["frames"])
            np.testing.assert_array_equal(ts["last_ep_ret"].numpy()[0],
                                          np.asarray(js["last_ep_ret"]))
    assert log.smallest() > MARGIN
    assert ts["filled"] == int(js["filled"]) == 40
    assert _max_err(ts["params"], js["params"]) <= TOL
    assert _max_err(ts["target_params"], js["target_params"]) <= TOL
    assert _max_err(ts["opt_state"]["g"], js["opt_state"]["g"]) <= TOL
    _check_buffers(ts["buffer"], js["buffer"])
    np.testing.assert_array_equal(ts["obs"].numpy()[0], np.asarray(js["obs"]))


def test_replay_async_matches_jax():
    env_j, env_t, pj, pt = _agent(32)
    ja, ta = jax_agents.ALGORITHMS["n_step_q"](), \
        agents.ALGORITHMS["n_step_q"]()
    cfg = dict(n_workers=4, t_max=5, buffer_size=64, replay_batch=8,
               warmup=16)
    ji, jround = jax_ra.make_replay_runner(
        ja, env_j, pj, jax_ra.ReplayAsyncConfig(**cfg))
    ti, tround = replay_async.make_replay_runner(
        ta, env_t, pt, replay_async.ReplayAsyncConfig(**cfg))
    js, ts = ji(jax.random.key(1)), ti(prng.key(1))
    with prng.margins() as log:
        for _ in range(8):
            js, jm = jround(js)
            ts, tm = tround(ts)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=TOL, atol=1e-7, err_msg=k)
            assert _max_err(ts["params"], js["params"]) <= TOL
    assert log.smallest() > MARGIN
    assert ts["filled"] == int(js["filled"][0]) == 40
    assert (np.asarray(js["filled"]) == 40).all()
    assert ts["ptr"] == int(js["ptr"][0])
    assert _max_err(ts["target_params"], js["target_params"]) <= TOL
    assert _max_err(ts["opt_state"]["g"], js["opt_state"]["g"]) <= TOL
    _check_buffers(ts["buffer"], js["buffer"])


def test_merge_every_semantics():
    trees = [{"a": torch.ones(3)}, {"a": 3 * torch.ones(3)}]
    merged = delayed_sync.merge_every(2, 2, [dict(t) for t in trees])
    for t in merged:
        np.testing.assert_allclose(t["a"].numpy(), 2.0)    # 2 % 2 == 0
    kept = delayed_sync.merge_every(3, 2, [{"a": torch.ones(3)},
                                           {"a": 3 * torch.ones(3)}])
    np.testing.assert_allclose(kept[1]["a"].numpy(), 3.0)
    want = jax_ds.merge_every(jnp.asarray(4), 2, jnp.stack(
        [jnp.arange(3.0), 2 * jnp.arange(3.0)]))
    got = delayed_sync.merge_every(4, 2, [{"a": torch.arange(3.0)},
                                          {"a": 2 * torch.arange(3.0)}])
    for i in range(2):
        np.testing.assert_array_equal(got[i]["a"].numpy(),
                                      np.asarray(want[i]))


@pytest.mark.parametrize("merge_opt_state", [True, False])
def test_delayed_sync_matches_jax(merge_opt_state):
    arch, groups, h = "stablelm-1.6b", 2, 3
    cj, ct = jax_config(arch).reduced(), get_config(arch).reduced()
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, _np(pj), "cpu")
    oj, ot = jax_opt.shared_rmsprop(), opt_mod.shared_rmsprop()
    pjg = jax_ds.replicate(pj, groups)
    ojg = jax_ds.replicate(oj.init(pj), groups)
    ptg = delayed_sync.replicate(pt, groups)
    otg = [ot.init(p) for p in ptg]
    kw = dict(n_groups=groups, merge_interval=h, lr=1e-3,
              merge_opt_state=merge_opt_state)
    jstep = jax.jit(jax_ds.make_delayed_train_step(cj, oj, **kw))
    tstep = delayed_sync.make_delayed_train_step(ct, ot, **kw)
    jpipe = JaxPipeline(vocab=cj.vocab_size, seq_len=32, global_batch=2)
    tpipe = TokenPipeline(vocab=ct.vocab_size, seq_len=32, global_batch=2,
                          device="cpu")

    def spread(trees):
        return max(float((a - b).detach().abs().max()) for a, b in zip(
            flatten(trees[0]).values(), flatten(trees[1]).values()))

    for i in range(h):
        bj = jax.vmap(lambda k: jpipe.batch(k, i))(
            jax.random.split(jax.random.key(i), groups))
        keys = prng.split(prng.key(i), groups)
        bt = [tpipe.batch(keys[g], i) for g in range(groups)]
        pjg, ojg, mj = jstep(pjg, ojg, bj, jnp.asarray(i))
        ptg, otg, mt = tstep(ptg, otg, bt, i)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=TOL)
        for g in range(groups):
            want = TM.flatten(bridge.params_from_jax(
                ct, jax.tree.map(lambda a: np.asarray(a)[g], pjg), "cpu"))
            got = TM.flatten(ptg[g])
            assert max(float((got[k].detach() - w).abs().max())
                       for k, w in want.items()) <= TOL
        if i < h - 1:
            assert spread(ptg) > 0.0       # groups drift between merges
        else:
            assert spread(ptg) == 0.0      # merge point: identical again
    assert (spread([o["g"] for o in otg]) == 0.0) == merge_opt_state
