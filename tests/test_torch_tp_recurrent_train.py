"""The port's tensor- and sequence-parallel train step for the recurrent
and encoder-decoder blocks (slice 6b-ii) against the JAX package's
unsharded one, on the CPU over gloo ranks.

Two worlds run side by side: two ranks on (data 1, model 2) and four on
(data 2, model 2) (FSDP over data as well).  Each case starts from the
JAX package's parameters (``bridge``) held as ``fsdp.layout`` holds them
under tensor parallelism and takes three Shared RMSProp steps on the same
numpy batches, every rank on its data rows and its half of the sequence:
reduced zamba2 (two mamba2 layers, ``in_proj`` and conv split part by
part, and the shared attention block after the second), xlstm on the
("mlstm", "slstm") cycle (the sLSTM's ``r`` split over its heads) and
Whisper (its vocab of 512 split: the vocab-parallel embedding and loss;
the encoder on this rank's frames), each with remat and without (Whisper
has none, as in the reference: its flag changes nothing).  The
parameters, gathered whole, and the losses are held to JAX's unsharded
``make_train_step`` within 1e-5 (one JAX run serves both remat cases).

Also, at one step, every leaf's gradient (``loss_grads``, gathered whole)
against ``jax.grad`` of the reference's ``a3c_token_loss``; each run's
collectives exactly ``chip_smoke._step_collectives`` and its routes
exactly ``chip_smoke._mr_routes`` (local heads on every recurrent layer,
its norm on feature-gathered rows, cross attention on local heads); a
checkpoint of blocked and moved shards that equals the single-process
file bit for bit and restores each rank's shards; and the remat
recompute keeping the tensor-parallel route outside the rules.
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
ARCHS = ("zamba2", "xlstm", "whisper")
MESHES = {2: (1, 2), 4: (2, 2)}


def _configs(pkg):
    return {"zamba2": pkg.get_config("zamba2-1.2b").reduced(),
            "xlstm": dataclasses.replace(
                pkg.get_config("xlstm-1.3b").reduced(),
                block_cycle=("mlstm", "slstm")),
            "whisper": pkg.get_config("whisper-base").reduced()}


def _batch_np(seed, cfg, gamma=0.99):
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    first = rng.integers(0, vocab, (B, 1))
    succ = (first + np.arange(S)[None]) % vocab
    noise = rng.random((B, S)) < 0.3
    tokens = np.where(noise, rng.integers(0, vocab, (B, S)), succ)
    rewards = (np.roll(tokens, -1, 1) == (tokens + 1) % vocab)
    rewards = rewards.astype(np.float32)
    rewards[:, -1] = 0.0
    done = np.zeros((B, S), np.float32)
    done[:, -1] = 1.0
    out = {"tokens": tokens.astype(np.int32), "rewards": rewards,
           "discounts": (gamma * (1.0 - done)).astype(np.float32)}
    if cfg.is_encdec:
        out["enc_frames"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return out


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


def _run_case(ct, mesh, inputs, arch):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.optim import optimizers as opt_mod
    lay = fsdp.layout(ct, mesh)
    assert lay.tp
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
            "counts": counts,
            "shapes": {k: tuple(v.shape) for k, v in
                       _np_tree(params).items()}}


def _grads_once(ct, mesh, inputs, arch):
    """Every leaf's gradient at the bridged parameters, gathered whole."""
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import fsdp, sharding
    lay = fsdp.layout(ct, mesh)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    with _scope(mesh, ct):
        grads, met = llm_a3c.loss_grads(
            ct, params, sharding.shard_batch(
                mesh, _tb(inputs[arch]["batches"][0])), layout=lay)
    return {"loss": float(met["loss"]),
            "grads": _np_tree(fsdp.full(lay, grads))}


def _checkpoint(ct, mesh, inputs, arch, out_dir, world):
    from repro_torch import bridge, checkpoint
    from repro_torch.distributed import fsdp
    from repro_torch.models import model as TM
    lay = fsdp.layout(ct, mesh)
    shards = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    path = os.path.join(out_dir, f"tp{world}_{arch}.npz")
    checkpoint.save(path, shards, lay)
    dist.barrier()
    back = checkpoint.restore(path, TM.tree_map(torch.zeros_like, shards),
                              lay)
    return all(torch.equal(a, b) for a, b in zip(
        TM.flatten(back).values(), TM.flatten(shards).values()))


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
        mesh = mesh_mod.make_mesh(MESHES[world], "cpu")
        out = {}
        for arch in ARCHS:
            for remat in (False, True):
                ct = dataclasses.replace(cfgs[arch], remat=remat)
                out[(arch, remat)] = _run_case(ct, mesh, inputs, arch)
            out[(arch, "grads")] = _grads_once(cfgs[arch], mesh, inputs,
                                               arch)
        out["restored"] = {a: _checkpoint(cfgs[a], mesh, inputs, a, out_dir,
                                          world)
                           for a in ("zamba2", "xlstm")}
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
    tmp = tmp_path_factory.mktemp("tprt")
    cfgs = _configs(jax_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {"params": jax.tree.map(np.asarray, pj),
                        "batches": [_batch_np(10 + i, cj)
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


CASES = [(w, a, r) for w in MESHES for a in ARCHS for r in (False, True)]


@pytest.mark.parametrize("world,arch,remat", CASES, ids=[
    f"{'x'.join(map(str, MESHES[w]))}-{a}-{'remat' if r else 'plain'}"
    for w, a, r in CASES])
def test_tp_step_matches_unsharded_jax(ranks, jax_refs, world, arch, remat):
    """Three steps against the reference's, the ranks agreeing bit for bit
    and issuing exactly ``chip_smoke``'s collectives and routes; a rank
    holds 1/2 of every split leaf (mamba2's ``in_proj`` and conv part by
    part, the sLSTM's ``r`` over its heads)."""
    from repro_torch.distributed import fsdp, sharding
    want = jax_refs[arch]
    res = ranks[world]
    for r in res:
        got = r[(arch, remat)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        err = _max_err(got["params"], want["params"])
        assert err <= TOL, (arch, remat, err)
    for r in res[1:]:
        assert _max_err(r[(arch, remat)]["params"],
                        res[0][(arch, remat)]["params"]) == 0.0
        assert r[(arch, remat)]["counts"] == res[0][(arch, remat)]["counts"]
    collective, routes = res[0][(arch, remat)]["counts"]
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=remat)
    mesh = dict(zip(("data", "model"), MESHES[world]))
    lay = fsdp.layout(ct, mesh)
    cs = _chip_smoke()
    per_step = cs._step_collectives(ct, lay, mesh)
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    want_r = cs._mr_routes(ct, lay)
    assert {k: routes[k] for k in want_r} == \
        {k: STEPS * v for k, v in want_r.items()}
    kinds = set(ct.layer_kinds())
    assert routes["tp_ssm_heads"] > 0 or "mamba2" not in kinds
    assert routes["tp_lstm_heads"] > 0 or not kinds & {"mlstm", "slstm"}
    assert routes["tp_cross"] > 0 or not ct.is_encdec
    # the shards: 1/2 of each split leaf's model dim, 1/2 of its data dim
    # on (2, 2)
    shapes = res[0][(arch, remat)]["shapes"]
    for path, spec in lay.held.items():
        whole = lay.shapes[path]
        n = [sharding.axes_size(mesh, sharding.entry_axes(a)) for a in spec]
        assert shapes[path] == tuple(w // k for w, k in zip(whole, n)), path
        if path.endswith((".mamba.in_proj.w", ".slstm.r")):
            assert "model" in spec


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_gradient_matches_jax_at_one_step(ranks, jax_refs, world,
                                                     arch):
    want = jax_refs[arch]
    for r in ranks[world]:
        got = r[(arch, "grads")]
        np.testing.assert_allclose(got["loss"], want["loss0"], rtol=TOL)
        for k, g in want["grads"].items():
            scale = max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grads"][k], g, rtol=TOL,
                                       atol=TOL * scale, err_msg=k)


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("arch", ["zamba2", "xlstm"])
def test_blocked_and_moved_checkpoint_equals_the_single_process_file(
        setup, ranks, world, arch):
    """Zamba2's blocked ``in_proj`` and conv shards and xlstm's ``r``
    split over its heads: the file the ranks write is the single-process
    file of the same parameters, and restoring it hands each rank its
    shards back."""
    from repro_torch import bridge, checkpoint
    _, tmp, _, inputs = setup
    ct = _configs(_torch_configs())[arch]
    params = bridge.params_from_jax(ct, inputs[arch]["params"], "cpu")
    checkpoint.save(str(tmp / f"single{world}_{arch}.npz"), params)
    with np.load(tmp / f"single{world}_{arch}.npz") as a, \
            np.load(tmp / f"tp{world}_{arch}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    assert all(r["restored"][arch] for r in ranks[world])


@pytest.mark.parametrize("arch", ["zamba2", "xlstm"])
def test_remat_recompute_keeps_the_tp_route_without_the_rules(arch):
    """The recompute of a remat block takes the tensor-parallel route its
    forward took even where the rules are not installed (a card's
    backward runs on the autograd engine's device thread, which does not
    see the thread-local rules): on a one-rank (1, 1) mesh with tensor
    parallelism asked for, the backward runs after the rules are gone and
    every recurrent layer still runs on local heads with its norm on
    feature-gathered rows twice, and the collectives are the counted ones
    less the gradient and metric all-reduces of ``loss_grads``."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=True)
    b = _tb(_batch_np(1, ct))
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        lay = fsdp.layout(ct, mesh, force_tp=True)
        params = fsdp.shard(lay, TM.init_params(ct, 0, "cpu"))
        leaves = list(TM.flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        collectives.reset_counts()
        dispatch.reset_launch_counts()
        with ctx.sharding_rules(sharding.activation_rules(
                mesh, batch_size=B, cfg=ct)):
            loss, _ = llm_a3c.a3c_token_loss(ct, params, b, layout=lay)
        assert ctx.current_rules() is None
        torch.autograd.grad(loss, leaves)
    routes = dispatch.route_counts()
    kinds = ct.layer_kinds()
    ssm = sum(1 for k in kinds if k == "mamba2")
    lstm = len(kinds) - ssm
    assert routes["tp_ssm_heads"] == 2 * ssm
    assert routes["tp_lstm_heads"] == 2 * lstm
    assert routes["tp_feature_rows"] == 2 * len(kinds)
    cs = _chip_smoke()
    assert {k: routes[k] for k in cs._mr_routes(ct, lay)} == \
        cs._mr_routes(ct, lay)
    want = cs._step_collectives(ct, lay, mesh)
    # loss_grads' all-reduces: one a leaf not sharded over data, and the
    # metrics'
    axes = sharding.data_axes(mesh)
    n_whole = sum(1 for p in lay.held
                  if not any(lay.sharded(p, a) for a in axes))
    assert collectives.counts() == dict(
        want, all_reduce=want["all_reduce"] - n_whole - 1)
