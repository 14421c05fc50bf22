"""The port's sequence-sharded attention in the multi-rank train step
(slice 6b-iii) against the JAX package's unsharded step, on the CPU over
gloo ranks.

Where a config's q heads do not divide the model axis the reference pins
the sequence, not the heads ("attn_q" (dp, "model", None, None)): each
model rank keeps its rows of the sequence and attends them against the
whole sequence's keys.  The port does so with explicit collectives
(``attention._attend_seq``): wq's columns and wo's rows, held off head
boundaries, gathered at use (their backward a reduce-scatter), wk and wv
held whole where their heads do not divide either, k and v gathered
along the sequence, and the flash kernels' query-offset arm.

Two worlds run side by side: two ranks on (data 1, model 2), four on
(1, 4) and on (2, 2) (FSDP over data as well).  Reduced configs whose q
heads divide neither 2 nor 4: a minicpm-like MHA config (3 q / 3 kv
heads, the tied vocab-parallel table), a scout-like GQA MoE config (5 q
/ 1 kv head, G = 5 as Llama-4-Scout's, its ``attn_local`` layers under
an 8-key window shorter than S = 32, experts expert-parallel on the
sequence rows at capacity factor 4.0 with no load-balance loss, so
nothing drops), and stablelm (4 / 4 heads, layernorm, partial rotary)
with the sequence arm forced (``fsdp.layout(force_seq=True)``), whose kv
leaves are split and gathered.  Each case starts from the JAX package's
parameters (``bridge``) and takes three Shared RMSProp steps with remat
and without: losses and the whole parameters within ``TOL`` = 1e-5 of
JAX's ``make_train_step``; at one step every leaf's gradient within 1e-5
of ``jax.grad`` of the reference's loss; each run's collectives exactly
``chip_smoke._step_collectives`` and its routes exactly
``chip_smoke._mr_routes`` (``tp_seq`` on every attention layer, again in
the remat recompute).  Also the recompute's route without the rules.
"""
import contextlib
import dataclasses
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32
LR0, TOTAL = 7e-4, 10
STEPS = 3
TOL = 1e-5
ARCHS = ("minicpm", "scout", "stablelm")
FORCED = ("stablelm",)          # heads that divide: the arm forced
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}


def _configs(pkg):
    return {"minicpm": dataclasses.replace(
                pkg.get_config("minicpm-2b").reduced(), n_heads=3,
                n_kv_heads=3),
            "scout": dataclasses.replace(
                pkg.get_config("llama4-scout-17b-a16e").reduced(),
                n_heads=5, n_kv_heads=1, sliding_window=8,
                capacity_factor=4.0, aux_loss_weight=0.0),
            "stablelm": pkg.get_config("stablelm-1.6b").reduced()}


def _batch_np(seed, vocab, gamma=0.99):
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


def _tb(b):
    out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _np_tree(tree):
    from repro_torch.models import model as TM
    return {k: v.detach().numpy().copy() for k, v in TM.flatten(tree).items()}


@contextlib.contextmanager
def _scope(mesh, cfg):
    from repro_torch.distributed import ctx, sharding
    with ctx.use_mesh(mesh), ctx.sharding_rules(sharding.activation_rules(
            mesh, batch_size=B, cfg=cfg)):
        yield


def _layout(ct, mesh, arch):
    from repro_torch.distributed import fsdp
    lay = fsdp.layout(ct, mesh, force_seq=arch in FORCED)
    assert lay.tp and lay.seq
    return lay


def _run_case(ct, mesh, inputs, arch):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.optim import optimizers as opt_mod
    lay = _layout(ct, mesh, arch)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = llm_a3c.make_train_step(ct, opt, lr0=LR0, total_steps=TOTAL,
                                   layout=lay)
    losses = []
    collectives.reset_counts()
    dispatch.reset_launch_counts()
    with _scope(mesh, ct):
        for i, b in enumerate(inputs[arch]["batches"]):
            batch = sharding.shard_batch(mesh, _tb(b))
            params, state, met = step(params, state, batch, i)
            losses.append(float(met["loss"]))
    counts = (collectives.counts(), dispatch.route_counts())
    return {"losses": losses, "params": _np_tree(fsdp.full(lay, params)),
            "counts": counts}


def _grads_once(ct, mesh, inputs, arch):
    """Every leaf's gradient at the bridged parameters, gathered whole."""
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import fsdp, sharding
    lay = _layout(ct, mesh, arch)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    with _scope(mesh, ct):
        grads, met = llm_a3c.loss_grads(
            ct, params, sharding.shard_batch(
                mesh, _tb(inputs[arch]["batches"][0])), layout=lay)
    return {"loss": float(met["loss"]),
            "grads": _np_tree(fsdp.full(lay, grads))}


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch import configs as torch_configs
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cfgs = _configs(torch_configs)
        out = {}
        for shape in MESHES[world]:
            mesh = mesh_mod.make_mesh(shape, "cpu")
            for arch in ARCHS:
                for remat in (False, True):
                    ct = dataclasses.replace(cfgs[arch], remat=remat)
                    out[(shape, arch, remat)] = _run_case(ct, mesh, inputs,
                                                          arch)
                out[(shape, arch, "grads")] = _grads_once(cfgs[arch], mesh,
                                                          inputs, arch)
        with open(os.path.join(out_dir, f"w{world}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's parameters and the batches written for the ranks, both worlds
    started (not joined); the JAX references are computed meanwhile."""
    import jax
    from repro import configs as jax_configs
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("tpseq")
    cfgs = _configs(jax_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {"params": jax.tree.map(np.asarray, pj),
                        "batches": [_batch_np(10 + i, cj.vocab_size)
                                    for i in range(STEPS)]}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = {w: mp.spawn(_rank_main, args=(w, _free_port(), str(tmp)),
                         nprocs=w, join=False) for w in MESHES}
    return procs, tmp, cfgs, inputs


def _jax_flat(cj, tree):
    import jax

    from repro_torch import bridge
    from repro_torch.models import model as TM
    flat = TM.flatten(bridge._unstack(cj, jax.tree.map(np.asarray, tree)))
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's unsharded train step and its gradients at step 0, from the
    same parameters and batches."""
    import jax
    import jax.numpy as jnp
    from repro.core import llm_a3c as jax_a3c
    from repro.optim import optimizers as jax_opt
    _, _, cfgs, inputs = setup
    out = {}
    for arch in ARCHS:
        cj = cfgs[arch]
        opt = jax_opt.shared_rmsprop(fused=False)
        step = jax.jit(jax_a3c.make_train_step(cj, opt, lr0=LR0,
                                               total_steps=TOTAL))
        params = jax.tree.map(jnp.asarray, inputs[arch]["params"])
        b0 = {k: jnp.asarray(v) for k, v in inputs[arch]["batches"][0].items()}
        (loss0, _), g0 = jax.value_and_grad(
            lambda p: jax_a3c.a3c_token_loss(cj, p, b0), has_aux=True)(params)
        state = opt.init(params)
        losses = []
        for i, b in enumerate(inputs[arch]["batches"]):
            params, state, met = step(params, state,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()}, jnp.asarray(i))
            losses.append(float(met["loss"]))
        out[arch] = {"losses": losses, "params": _jax_flat(cj, params),
                     "loss0": float(loss0), "grads": _jax_flat(cj, g0)}
    return out


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    procs, tmp, _, _ = setup
    out = {}
    for w, p in procs.items():
        while not p.join():
            pass
        out[w] = []
        for r in range(w):
            with open(tmp / f"w{w}_rank{r}.pkl", "rb") as f:
                out[w].append(pickle.load(f))
    return out


def _max_err(got, want):
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in got)


def _torch_configs():
    from repro_torch import configs
    return configs


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


CASES = [(w, s, a, r) for w in MESHES for s in MESHES[w] for a in ARCHS
         for r in (False, True)]


@pytest.mark.parametrize("world,shape,arch,remat", CASES, ids=[
    f"{'x'.join(map(str, s))}-{a}-{'remat' if r else 'plain'}"
    for w, s, a, r in CASES])
def test_seq_step_matches_unsharded_jax(ranks, jax_refs, world, shape, arch,
                                        remat):
    want = jax_refs[arch]
    res = [r[(shape, arch, remat)] for r in ranks[world]]
    for got in res:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        err = _max_err(got["params"], want["params"])
        assert err <= TOL, (arch, remat, err)
    # every rank holds the same whole parameters and issued the same
    # collectives: exactly the counts phase 12 gates on the card
    for got in res[1:]:
        assert _max_err(got["params"], res[0]["params"]) == 0.0
        assert got["counts"] == res[0]["counts"]
    collective, routes = res[0]["counts"]
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=remat)
    mesh = dict(zip(("data", "model"), shape))
    lay = _layout(ct, mesh, arch)
    cs = _chip_smoke()
    per_step = cs._step_collectives(ct, lay, mesh)
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    want_r = cs._mr_routes(ct, lay)
    assert {k: routes[k] for k in want_r} == \
        {k: STEPS * v for k, v in want_r.items()}
    layers = ct.n_layers * (1 + remat)
    assert routes["tp_seq"] == STEPS * layers and routes["tp_heads"] == 0
    assert routes["tp_kv_whole"] == \
        STEPS * layers * (ct.n_kv_heads % shape[1] != 0)


@pytest.mark.parametrize("world,shape", [(w, s) for w in MESHES
                                         for s in MESHES[w]])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gradient_matches_jax_at_one_step(ranks, jax_refs, world,
                                                     shape, arch):
    want = jax_refs[arch]
    for r in ranks[world]:
        got = r[(shape, arch, "grads")]
        np.testing.assert_allclose(got["loss"], want["loss0"], rtol=TOL)
        for k, g in want["grads"].items():
            scale = max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grads"][k], g, rtol=TOL,
                                       atol=TOL * scale, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recompute_keeps_the_seq_route_without_the_rules(arch):
    """The recompute of a remat block takes the sequence arm its forward
    took even where the rules are not installed (a card's backward runs
    on the autograd engine's device thread): on a one-rank (1, 1) mesh
    with the arm forced, the backward runs after the rules are gone and
    every layer attends its rows twice, through the query-offset arm."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=True)
    b = _tb(_batch_np(1, ct.vocab_size))
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        lay = fsdp.layout(ct, mesh, force_seq=True)
        params = fsdp.shard(lay, TM.init_params(ct, 0, "cpu"))
        leaves = list(TM.flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        dispatch.reset_launch_counts()
        with ctx.sharding_rules(sharding.activation_rules(
                mesh, batch_size=B, cfg=ct)):
            loss, _ = llm_a3c.a3c_token_loss(ct, params, b, layout=lay)
        assert ctx.current_rules() is None
        torch.autograd.grad(loss, leaves)
    routes = dispatch.route_counts()
    assert routes["tp_seq"] == 2 * ct.n_layers
    assert routes["tp_heads"] == 0
