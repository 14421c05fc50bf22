"""The port's learner against the JAX package's, on the CPU.

Reduced Yi-6B (2 layers, d 256, 4 q heads over 1 kv head, f32) with the
JAX package's parameters and an RMSProp accumulator moved over by
``repro_torch.bridge``, and batches made with numpy from a seed and handed
to both sides: the A3C token loss and its metrics (rtol 1e-5), every
leaf's gradient against ``jax.grad`` (max |diff| <= 1e-4 max |g_jax|: XLA
and PyTorch sum the gradients of a 2-layer model in different orders), and
the parameters after three ``shared_rmsprop`` steps at the learner's
default lr0 against the JAX train step with both its unfused and its
Pallas optimizer (rtol 1e-5, atol 1e-6).
Then the pieces around the step: returns, the token MDP, the data
pipeline (its batches equal ``repro.data.pipeline``'s on one key),
checkpoints and the train CLI (its first loss from ``--seed`` equals the
JAX CLI's: the same initial weights and batches, drawn by
``repro_torch.core.prng``).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import llm_a3c as jax_a3c  # noqa: E402
from repro.core import returns as jax_returns  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.envs import token_mdp as jax_mdp  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro.optim import schedules as jax_sched  # noqa: E402
from repro_torch import bridge, checkpoint  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.core import llm_a3c, prng, returns  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.envs.token_mdp import TokenMDP, TokenMDPState  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 128
LR0, TOTAL = 7e-4, 10          # make_train_step's default lr0


def _batch_np(seed, vocab, gamma=0.99):
    """A noisy-successor batch, with the pipeline's reward and discount
    rules, in numpy."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, vocab, (B, 1))
    succ = (first + np.arange(S)[None]) % vocab
    noise = rng.random((B, S)) < 0.3
    tokens = np.where(noise, rng.integers(0, vocab, (B, S)), succ)
    rewards = (np.roll(tokens, -1, 1) == (tokens + 1) % vocab)
    rewards = rewards.astype(np.float32)
    rewards[:, -1] = 0.0
    done = np.zeros((B, S), np.float32)
    done[:, -1] = 1.0
    discounts = (gamma * (1.0 - done)).astype(np.float32)
    return {"tokens": tokens.astype(np.int32), "rewards": rewards,
            "discounts": discounts}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    out = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def _partitionable():
    """jax's threefry layout of jax 0.5 on, the port's default."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def setup():
    cj = jax_configs.get_config("yi-6b").reduced()
    ct = torch_configs.get_config("yi-6b").reduced()
    assert (ct.n_layers, ct.d_model, ct.n_heads, ct.n_kv_heads) == \
        (2, 256, 4, 1)
    pj = JM.init_params(cj, jax.random.key(0))
    # a non-zero accumulator, the same on both sides
    rng = np.random.default_rng(5)
    gj = jax.tree.map(lambda p: jnp.asarray(
        np.abs(rng.standard_normal(p.shape)).astype(np.float32) * 1e-2), pj)
    batches = [_batch_np(10 + i, cj.vocab_size) for i in range(3)]
    return cj, ct, pj, {"g": gj}, batches


def _port_params(ct, pj):
    return bridge.params_from_jax(ct, _to_np(pj), device="cpu")


def _port_grads(ct, pt, batch):
    leaves = list(TM.flatten(pt).values())
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = llm_a3c.a3c_token_loss(ct, pt, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(TM.flatten(pt), grads))


def test_loss_and_metrics_match_jax(setup):
    cj, ct, pj, _, batches = setup
    loss_j, met_j = jax.jit(lambda p, b: jax_a3c.a3c_token_loss(cj, p, b))(
        pj, _jax_batch(batches[0]))
    loss_t, met_t = llm_a3c.a3c_token_loss(ct, _port_params(ct, pj),
                                           _torch_batch(batches[0]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(met_t) == set(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_every_gradient_matches_jax_grad(setup):
    cj, ct, pj, _, batches = setup
    gj = jax.jit(jax.grad(lambda p, b: jax_a3c.a3c_token_loss(cj, p, b)[0]))(
        pj, _jax_batch(batches[0]))
    want = TM.flatten(bridge.params_from_jax(ct, _to_np(gj), device="cpu"))
    got = _port_grads(ct, _port_params(ct, pj), batches[0])
    assert set(got) == set(want) and len(got) == 22
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        scale = float(w.abs().max())
        assert scale > 0, path
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (path, err, scale)


def test_remat_gives_the_same_gradients(setup):
    _, ct, pj, _, batches = setup
    plain = _port_grads(ct, _port_params(ct, pj), batches[1])
    remat = _port_grads(dataclasses.replace(ct, remat=True),
                        _port_params(ct, pj), batches[1])
    for path, g in plain.items():
        if path == "embed.table":
            # the gather's backward scatter-adds repeated tokens' rows in
            # an order that varies with CPU threads, remat or not
            err = float((g - remat[path]).abs().max())
            assert err <= 1e-6 * float(g.abs().max()), err
        else:
            assert torch.equal(g, remat[path]), path


def _jax_train_step(cj, fused):
    opt = jax_opt.shared_rmsprop(fused=fused)
    if not fused:
        return jax.jit(jax_a3c.make_train_step(cj, opt, lr0=LR0,
                                               total_steps=TOTAL))
    # Two faults of the reference's fused path (ROADMAP.md, queue 3): the
    # Pallas optimizer takes lr as a static argument, which the traced lr
    # of a jitted make_train_step cannot be, and its is_leaf takes the
    # scan-stacked layers tuple for a (new_g, update) pair.  So the same
    # step body runs here with a host-float lr, the optimizer leaf by leaf.
    grad_fn = jax.jit(jax.grad(lambda p, b: jax_a3c.a3c_token_loss(
        cj, p, b), has_aux=True))

    def step(params, state, batch, i):
        lr = float(jax_sched.linear_anneal(LR0, i.astype(jnp.float32),
                                           float(TOTAL)))
        grads, metrics = grad_fn(params, batch)
        flat_g, treedef = jax.tree.flatten(state["g"])
        out = [opt.update(dg, {"g": g}, lr) for g, dg in
               zip(flat_g, treedef.flatten_up_to(grads))]
        updates = treedef.unflatten([u for u, _ in out])
        state = {"g": treedef.unflatten([s["g"] for _, s in out])}
        return jax_opt.apply_updates(params, updates), state, metrics
    return step


@pytest.mark.parametrize("fused", [False, True])
def test_three_shared_rmsprop_steps_match_jax(setup, fused):
    cj, ct, pj, sj, batches = setup
    step_j = _jax_train_step(cj, fused)
    opt_t = opt_mod.shared_rmsprop()
    step_t = llm_a3c.make_train_step(ct, opt_t, lr0=LR0, total_steps=TOTAL)
    pt = _port_params(ct, pj)
    st = bridge.opt_state_from_jax(ct, _to_np(sj), device="cpu")
    g_before = st["g"]["layers"][0]["mlp"]["up"]["w"]
    p_before = pt["layers"][0]["mlp"]["up"]["w"]
    for i, b in enumerate(batches):
        pj_next, sj, met_j = step_j(pj, sj, _jax_batch(b), jnp.asarray(i))
        pt, st, met_t = step_t(pt, st, _torch_batch(b), i)
        pj = pj_next
        np.testing.assert_allclose(float(met_t["loss"]),
                                   float(met_j["loss"]), rtol=1e-5)
    # the port updates in place
    assert pt["layers"][0]["mlp"]["up"]["w"] is p_before
    assert st["g"]["layers"][0]["mlp"]["up"]["w"] is g_before
    for tree_t, tree_j in ((pt, pj), (st["g"], sj["g"])):
        want = TM.flatten(bridge.params_from_jax(ct, _to_np(tree_j),
                                                 device="cpu"))
        for path, t in TM.flatten(tree_t).items():
            np.testing.assert_allclose(t.detach().numpy(), want[path],
                                       rtol=1e-5, atol=1e-6, err_msg=path)


def test_momentum_sgd_matches_jax():
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(3)]
    oj, ot = jax_opt.momentum_sgd(alpha=0.5), opt_mod.momentum_sgd(alpha=0.5)
    pj = jax.tree.map(jnp.asarray, p)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        uj, sj = oj.update(jax.tree.map(jnp.asarray, g), sj, 0.1)
        pj = jax_opt.apply_updates(pj, uj)
        ut, st = ot.update({k: torch.from_numpy(v) for k, v in g.items()},
                           st, 0.1)
        opt_mod.apply_updates(pt, ut)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), pj[k], rtol=1e-6)


def test_schedules_match_jax():
    for step in (0, 1, 37, 99, 100, 150):
        np.testing.assert_allclose(
            schedules.linear_anneal(7e-3, step, 100.0),
            float(jax_sched.linear_anneal(7e-3, jnp.float32(step), 100.0)),
            rtol=1e-7)
        np.testing.assert_allclose(
            schedules.wsd(1e-2, step, 100),
            float(jax_sched.wsd(1e-2, jnp.float32(step), 100)), rtol=1e-6)
    _assert_log_uniform_matches_jax(0)
    assert set(schedules.SCHEDULES) == set(jax_sched.SCHEDULES)


def _assert_log_uniform_matches_jax(seed):
    """The per-experiment lr draw (paper §5.1) from one key: within 1 f32
    ulp of jax's (the uniform is exact; torch's exp and XLA's differ in
    the last place on about a tenth of the values), and inside
    [1e-4, 1e-2]."""
    got = schedules.log_uniform(prng.key(seed), shape=(1000,)).numpy()
    want = np.asarray(jax_sched.log_uniform(jax.random.key(seed),
                                            shape=(1000,)))
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()
    assert got.min() >= 1e-4 and got.max() <= 1e-2
    one = schedules.log_uniform(prng.key(seed))
    assert one.shape == () and abs(float(one) - float(
        jax_sched.log_uniform(jax.random.key(seed)))) <= 1e-9


@pytest.mark.parametrize("seed", (1, 7, 2**31 - 1))
def test_log_uniform_matches_jax(seed):
    _assert_log_uniform_matches_jax(seed)


# ---------------------------------------------------------------------------
# returns, the token MDP, the pipeline, checkpoints, the CLI
# ---------------------------------------------------------------------------

def test_returns_match_jax():
    rng = np.random.default_rng(1)
    t, b = 16, 3
    r = rng.standard_normal((t, b)).astype(np.float32)
    d = (0.99 * (rng.random((t, b)) > 0.1)).astype(np.float32)
    v = rng.standard_normal((t, b)).astype(np.float32)
    boot = rng.standard_normal(b).astype(np.float32)
    rt, dt, vt, bt = (torch.from_numpy(a) for a in (r, d, v, boot))
    want = jax_returns.n_step_returns(jnp.asarray(r), jnp.asarray(d),
                                      jnp.asarray(boot))
    np.testing.assert_allclose(returns.n_step_returns(rt, dt, bt), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(returns.n_step_returns_ref(rt, dt, bt), want,
                               rtol=1e-5, atol=1e-6)
    adv_j, ret_j = jax_returns.gae_advantages(
        jnp.asarray(r), jnp.asarray(d), jnp.asarray(v), jnp.asarray(boot),
        lam=0.9)
    adv_t, ret_t = returns.gae_advantages(rt, dt, vt, bt, lam=0.9)
    np.testing.assert_allclose(adv_t, adv_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret_t, ret_j, rtol=1e-5, atol=1e-6)


def test_token_mdp_matches_jax():
    rng = np.random.default_rng(2)
    vocab, ctx_len, ep = 11, 6, 4
    tokens = rng.integers(0, vocab, (3, ctx_len))
    mj, mt = jax_mdp.TokenMDP(vocab, ctx_len, ep), TokenMDP(vocab, ctx_len, ep)
    sj = jax_mdp.TokenMDPState(jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(1, jnp.int32),
                               jnp.asarray(0, jnp.int32))
    st = TokenMDPState(torch.from_numpy(tokens), torch.tensor(1),
                       torch.tensor(0))
    for _ in range(ctx_len + 1):                 # runs past the context end
        prev = np.asarray(sj.tokens)[:, max(int(sj.pos) - 1, 0)]
        actions = np.where(rng.random(3) < 0.5, (prev + 1) % vocab,
                           rng.integers(0, vocab, 3))
        sj, rj, dj = mj.step(sj, jnp.asarray(actions, jnp.int32))
        st, rt, dt = mt.step(st, torch.from_numpy(actions))
        np.testing.assert_array_equal(st.tokens.numpy(), sj.tokens)
        assert int(st.pos) == int(sj.pos) and int(st.t) == int(sj.t)
        np.testing.assert_array_equal(rt.numpy(), rj)
        assert bool(dt) == bool(dj)
    np.testing.assert_array_equal(
        mt.reward_for_sequence(torch.from_numpy(tokens)).numpy(),
        mj.reward_for_sequence(jnp.asarray(tokens, jnp.int32)))
    s0 = mt.reset(torch.Generator().manual_seed(0), 5)
    assert s0.tokens.shape == (5, ctx_len) and int(s0.pos) == 1
    assert int(s0.tokens[:, 1:].abs().sum()) == 0


def test_pipeline_batches():
    pipe = TokenPipeline(vocab=97, seq_len=64, global_batch=8, device="cpu")
    key = prng.key(3)
    b = pipe.batch(key, step=0)
    assert b["tokens"].shape == (8, 64) and b["tokens"].dtype == torch.int64
    assert b["rewards"].dtype == b["discounts"].dtype == torch.float32
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 97
    mdp = TokenMDP(97, 64, 64)
    assert torch.equal(b["rewards"], mdp.reward_for_sequence(b["tokens"]))
    want_disc = torch.full((8, 64), 0.99)
    want_disc[:, -1] = 0.0
    assert torch.equal(b["discounts"], want_disc)
    # the successor policy with 30 % noise: most rewards are earned
    assert 0.3 < float(b["rewards"][:, :-1].mean()) < 0.7
    # a stream per (key, step)
    assert torch.equal(pipe.batch(key, step=0)["tokens"], b["tokens"])
    assert not torch.equal(pipe.batch(key, step=1)["tokens"], b["tokens"])
    assert not torch.equal(pipe.batch(prng.key(4))["tokens"], b["tokens"])
    eps = dataclasses.replace(pipe, episode_len=16).batch(key)
    assert float((eps["discounts"] == 0).sum()) == 8 * 4


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 1), (5, 0), (5, 7)])
def test_pipeline_batches_match_jax(seed, step):
    """The train CLI's batches, key(seed + 2) folded with the step, equal
    the JAX pipeline's exactly."""
    kw = dict(vocab=512, seq_len=128, global_batch=4)
    with _partitionable():
        want = jax_pipeline.TokenPipeline(**kw).batch(
            jax.random.key(seed + 2), step)
        want = {k: np.asarray(v) for k, v in want.items()}
    got = TokenPipeline(**kw, device="cpu").batch(prng.key(seed + 2), step)
    for k in ("tokens", "rewards", "discounts"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_checkpoint_round_trip(tmp_path, setup):
    _, ct, pj, sj, _ = setup
    tree = {"params": _port_params(ct, pj),
            "opt": bridge.opt_state_from_jax(ct, _to_np(sj), device="cpu")}
    tree["params"]["layers"][1]["mlp"]["up"]["w"] = \
        tree["params"]["layers"][1]["mlp"]["up"]["w"].bfloat16()
    path = str(tmp_path / "ck" / "state.npz")
    checkpoint.save(path, tree)
    like = TM.tree_map(torch.zeros_like, tree)
    back = checkpoint.restore(path, like)
    for (k, a), b in zip(TM.flatten(tree).items(),
                         TM.flatten(back).values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    like["opt"]["g"]["embed"]["table"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, like)


def test_train_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "llm",
         "--arch", "yi-6b", "--reduced", "--steps", "3", "--seq", "128",
         "--batch", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_train_cli_first_loss_matches_jax_cli(capsys, monkeypatch):
    """``--seed 3``, nothing bridged: the port draws the JAX CLI's initial
    weights (within a few f32 ulps) and batches, so its first loss equals
    the JAX CLI's within 1e-5 relative."""
    from repro.launch import train as jax_train
    from repro_torch.launch import train as torch_train
    argv = ["--mode", "llm", "--arch", "yi-6b", "--reduced", "--steps", "1",
            "--seq", "64", "--batch", "2", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with _partitionable():
        jax_train.main()                     # parses sys.argv, prints
    import json
    want = json.loads(capsys.readouterr().out.splitlines()[0])["loss"]
    got = torch_train.main(argv + ["--device", "cpu"])["history"][0]["loss"]
    capsys.readouterr()
    np.testing.assert_allclose(got, want, rtol=1e-5)
