"""The port's learner on an MoE model against the JAX package's, on the CPU.

Reduced Granite-MoE (2 layers, d 256, 4 experts, top-2, f32) at its
reduced capacity factor and at 1.25 (tokens drop), with the JAX package's
parameters moved over by ``repro_torch.bridge`` and batches made with
numpy from a seed: the A3C token loss and its metrics, ``aux`` (the
experts' load-balance losses times ``aux_loss_weight``) among them, to
rtol 1e-5; every leaf's gradient against ``jax.grad`` (max |diff| <= 1e-4
max |g_jax|, the router's included: the load-balance loss reaches it);
remat's gradients equal to the plain ones; three Shared RMSProp steps
against the JAX train step (rtol 1e-5, atol 1e-6).  Then the entry
points: ``--mode llm --arch granite-moe-1b-a400m --reduced`` starts from
the JAX CLI's first loss, and ``examples/llm_policy_a3c.py``'s port prints
the JAX example's losses and aux over three steps (rtol 1e-4).
"""
import contextlib
import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import llm_a3c as jax_a3c  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402

ARCH = "granite-moe-1b-a400m"
B, S = 2, 64
LR0, TOTAL = 7e-4, 10


def _batch_np(seed, vocab, gamma=0.99):
    """A noisy-successor batch with the pipeline's reward and discount
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
    return {"tokens": tokens.astype(np.int32), "rewards": rewards,
            "discounts": (gamma * (1.0 - done)).astype(np.float32)}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    for k in ("tokens", "actions"):
        if k in out:
            out[k] = out[k].long()
    return out


@contextlib.contextmanager
def _partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


_SETUPS = {}


def _setup(cf):
    if cf not in _SETUPS:
        over = {} if cf is None else dict(capacity_factor=cf)
        cj = dataclasses.replace(jax_configs.get_config(ARCH).reduced(),
                                 **over)
        ct = dataclasses.replace(torch_configs.get_config(ARCH).reduced(),
                                 **over)
        pj = JM.init_params(cj, jax.random.key(0))
        rng = np.random.default_rng(5)
        gj = jax.tree.map(lambda p: jnp.asarray(np.abs(rng.standard_normal(
            p.shape)).astype(np.float32) * 1e-2), pj)
        batches = [_batch_np(10 + i, cj.vocab_size) for i in range(3)]
        _SETUPS[cf] = cj, ct, pj, {"g": gj}, batches
    return _SETUPS[cf]


def _port(ct, tree):
    return bridge.params_from_jax(ct, jax.tree.map(np.asarray, tree),
                                  device="cpu")


def _port_grads(ct, pt, batch):
    leaves = list(TM.flatten(pt).values())
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = llm_a3c.a3c_token_loss(ct, pt, _tb(batch))
    return dict(zip(TM.flatten(pt), torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("cf", [None, 1.25], ids=["reduced", "cf1.25"])
def test_loss_metrics_and_aux_match_jax(cf):
    cj, ct, pj, _, batches = _setup(cf)
    loss_j, met_j = jax.jit(lambda p, b: jax_a3c.a3c_token_loss(cj, p, b))(
        pj, _jb(batches[0]))
    loss_t, met_t = llm_a3c.a3c_token_loss(ct, _port(ct, pj),
                                           _tb(batches[0]))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(met_t) == set(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # aux = 0.01 x the two layers' load-balance losses, each at least 1
    assert float(met_t["aux"]) >= ct.aux_loss_weight * ct.n_layers


@pytest.mark.parametrize("cf", [None, 1.25], ids=["reduced", "cf1.25"])
def test_every_gradient_matches_jax_grad(cf):
    cj, ct, pj, _, batches = _setup(cf)
    gj = jax.jit(jax.grad(lambda p, b: jax_a3c.a3c_token_loss(cj, p, b)[0]))(
        pj, _jb(batches[0]))
    want = TM.flatten(_port(ct, gj))
    got = _port_grads(ct, _port(ct, pj), batches[0])
    assert set(got) == set(want)
    assert sum(".moe." in k for k in got) == 4 * ct.n_layers
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        scale = float(w.abs().max())
        assert scale > 0, path
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, (path, err, scale)


def test_aux_loss_gradient_reaches_the_router():
    """The router's gradient carries the load-balance term: with
    aux_loss_weight raised it moves by that term's gradient, which
    ``jax.grad`` of the JAX loss at the same weight gives too."""
    cj, ct, pj, _, batches = _setup(1.25)
    cj2 = dataclasses.replace(cj, aux_loss_weight=1.0)
    ct2 = dataclasses.replace(ct, aux_loss_weight=1.0)
    path = "layers.0.moe.router"
    base = _port_grads(ct, _port(ct, pj), batches[1])[path]
    heavy = _port_grads(ct2, _port(ct2, pj), batches[1])[path]
    want = TM.flatten(_port(ct2, jax.grad(lambda p: jax_a3c.a3c_token_loss(
        cj2, p, _jb(batches[1]))[0])(pj)))[path]
    assert float((heavy - base).abs().max()) > 1e-3 * float(
        base.abs().max())
    err = float((heavy - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_remat_gives_the_same_gradients():
    """Under ``cfg.remat`` every block runs under torch.utils.checkpoint,
    which must return (x, aux) and route the recomputation as the forward
    did (top-k a stable sort): the same gradients, the embedding's up to
    its scatter-add order."""
    _, ct, pj, _, batches = _setup(1.25)
    plain = _port_grads(ct, _port(ct, pj), batches[1])
    remat = _port_grads(dataclasses.replace(ct, remat=True), _port(ct, pj),
                        batches[1])
    for path, g in plain.items():
        if path == "embed.table":
            err = float((g - remat[path]).abs().max())
            assert err <= 1e-6 * float(g.abs().max()), err
        else:
            assert torch.equal(g, remat[path]), path


def test_embeds_batch_with_actions_matches_jax():
    """{"embeds", "actions"} batches (no tokens): the actions replace the
    rolled tokens, as in the reference's loss."""
    cj, ct, pj, _, batches = _setup(1.25)
    b = dict(batches[2])
    rng = np.random.default_rng(9)
    b["embeds"] = (0.02 * rng.standard_normal(
        (B, S, cj.d_model))).astype(np.float32)
    b["actions"] = b.pop("tokens")
    loss_j, met_j = jax_a3c.a3c_token_loss(cj, pj, _jb(b))
    loss_t, met_t = llm_a3c.a3c_token_loss(ct, _port(ct, pj), _tb(b))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]),
                               rtol=1e-5)


def test_three_shared_rmsprop_steps_match_jax():
    cj, ct, pj, sj, batches = _setup(1.25)
    step_j = jax.jit(jax_a3c.make_train_step(
        cj, jax_opt.shared_rmsprop(fused=False), lr0=LR0,
        total_steps=TOTAL))
    step_t = llm_a3c.make_train_step(ct, opt_mod.shared_rmsprop(), lr0=LR0,
                                     total_steps=TOTAL)
    pt = _port(ct, pj)
    st = bridge.opt_state_from_jax(ct, jax.tree.map(np.asarray, sj),
                                   device="cpu")
    for i, b in enumerate(batches):
        pj, sj, met_j = step_j(pj, sj, _jb(b), jnp.asarray(i))
        pt, st, met_t = step_t(pt, st, _tb(b), i)
        for k in ("loss", "aux"):
            np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                       rtol=1e-5, err_msg=k)
    for tree_t, tree_j in ((pt, pj), (st["g"], sj["g"])):
        want = TM.flatten(_port(ct, tree_j))
        for path, t in TM.flatten(tree_t).items():
            np.testing.assert_allclose(t.detach().numpy(), want[path],
                                       rtol=1e-5, atol=1e-6, err_msg=path)


def test_train_cli_first_loss_matches_jax_cli(capsys, monkeypatch):
    """``--mode llm --arch granite-moe-1b-a400m --reduced --device cpu``:
    nothing bridged, the port draws the JAX CLI's weights and batches, so
    its first loss is the JAX CLI's within 1e-5 relative."""
    from repro.launch import train as jax_train
    from repro_torch.launch import train as torch_train
    argv = ["--mode", "llm", "--arch", ARCH, "--reduced", "--steps", "1",
            "--seq", "64", "--batch", "2", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with _partitionable():
        jax_train.main()
    import json
    want = json.loads(capsys.readouterr().out.splitlines()[0])["loss"]
    got = torch_train.main(argv + ["--device", "cpu"])["history"][0]["loss"]
    capsys.readouterr()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_llm_policy_example_matches_jax_example(capsys):
    """Three steps of the port's ``examples/llm_policy_a3c.py`` (``--steps
    3 --device cpu``) against three steps of the JAX example's loop
    (reduced Granite-MoE, weights from key 0, shared RMSProp at lr0 3e-3,
    TokenPipeline 4 x 64 on key 7): each step's loss and aux to rtol
    1e-4, and the printed line is step 0's."""
    from repro.data.pipeline import TokenPipeline as JaxPipeline
    from repro_torch.examples import llm_policy_a3c
    cj = jax_configs.get_config(ARCH).reduced()
    with _partitionable():
        params = JM.init_params(cj, jax.random.key(0))
        opt = jax_opt.shared_rmsprop()
        state = opt.init(params)
        pipe = JaxPipeline(vocab=cj.vocab_size, seq_len=64, global_batch=4)
        step = jax.jit(jax_a3c.make_train_step(cj, opt, lr0=3e-3,
                                               total_steps=10**9))
        want = []
        for i in range(3):
            batch = pipe.batch(jax.random.key(7), i % 4)
            params, state, m = step(params, state, batch, jnp.asarray(i))
            want.append({k: float(m[k]) for k in ("loss", "aux")})
    got = llm_policy_a3c.main(["--steps", "3", "--device", "cpu"])
    for g, w in zip(got, want):
        for k in ("loss", "aux"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    line = capsys.readouterr().out.splitlines()[0]
    assert line.split()[:2] == ["step", "0"]
    fields = dict(re.findall(r"(\w+)=\s*(\S+)", line))
    np.testing.assert_allclose(float(fields["loss"]), got[0]["loss"],
                               atol=5e-4)
    np.testing.assert_allclose(float(fields["aux"]), got[0]["aux"],
                               atol=5e-5)
