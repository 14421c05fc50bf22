"""The port's multi-rank train step against the JAX package's unsharded one,
on the CPU over two gloo ranks.

Each case starts from the JAX package's parameters (``bridge``) and runs
three Shared RMSProp steps on the same numpy batches; every rank takes its
rows of each batch (``sharding.shard_batch``).  After three steps the
parameters, gathered whole, are within 1e-5 of JAX's unsharded
``make_train_step`` (data parallelism is the same step mathematically):

* reduced yi-6b on (data 2, model 1), held whole on each rank (the
  launcher's layout) and as the parameter plan's FSDP shards;
* reduced granite-moe at capacity factor 4.0 and ``aux_loss_weight`` 0 on
  both sides, under the ``moe_ep`` rule on (2, 1), held whole and as
  shards, and on (1, 2) as shards (experts over the model axis, and the
  attention, norms and vocab tensor- and sequence-parallel), with remat
  and without: nothing drops, so the expert-parallel block equals
  the dense one (``test_torch_moe_ep.py`` holds its load-balance loss and
  its drops to ``moe_apply_ep``).

Also: delayed sync on (pod 2, data 1, model 1), each pod one group,
against ``make_delayed_train_step(n_groups=2, merge_interval=2)``'s vmap
over groups, each group's parameters after three steps; an FSDP ``save``
whose file holds the single-process file's arrays bit for bit, and
``restore`` handing each rank its shards; the train CLI under torchrun
over two gloo ranks printing the JAX CLI's losses (rtol 1e-5); an
undivided batch under two ranks, and a tensor whose device does not match
the group's backend, each a ValueError.
"""
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
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
DELAYED_LR = 1e-3
STEPS = 3
TOL = 1e-5
# (name, arch, mesh shape, layout); "_remat" cases recompute each block
CASES = [("yi_replicated", "yi", (2, 1), "whole"),
         ("yi_fsdp", "yi", (2, 1), "fsdp"),
         ("granite_2x1_whole", "granite", (2, 1), "whole"),
         ("granite_2x1_fsdp", "granite", (2, 1), "fsdp"),
         ("granite_1x2_fsdp_remat", "granite", (1, 2), "fsdp"),
         ("granite_1x2_fsdp", "granite", (1, 2), "fsdp")]


def _case_config(cfgs, name, arch):
    return dataclasses.replace(cfgs[arch], remat=name.endswith("_remat"))


def _configs(pkg):
    yi = pkg.get_config("yi-6b").reduced()
    granite = dataclasses.replace(
        pkg.get_config("granite-moe-1b-a400m").reduced(),
        capacity_factor=4.0, aux_loss_weight=0.0)
    return {"yi": yi, "granite": granite}


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


def _tb(b):
    out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _np_tree(tree):
    from repro_torch.models import model as TM
    return {k: v.detach().numpy().copy() for k, v in TM.flatten(tree).items()}


def _run_case(name, arch, shape, held, inputs, cfgs):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import optimizers as opt_mod
    ct = _case_config(cfgs, name, arch)
    mesh = mesh_mod.make_mesh(shape, "cpu")
    params = bridge.params_from_jax(ct, inputs[arch]["params"], "cpu")
    lay = fsdp.layout(ct, mesh) if held == "fsdp" else None
    if lay is not None:
        params = fsdp.shard(lay, params)
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = llm_a3c.make_train_step(ct, opt, lr0=LR0, total_steps=TOTAL,
                                   layout=lay)
    rules = sharding.activation_rules(mesh, batch_size=B, cfg=ct)
    losses = []
    collectives.reset_counts()
    dispatch.reset_launch_counts()
    with ctx.use_mesh(mesh), ctx.sharding_rules(rules):
        for i, b in enumerate(inputs[arch]["batches"]):
            batch = sharding.shard_batch(mesh, _tb(b))
            params, state, met = step(params, state, batch, i)
            losses.append(float(met["loss"]))
    counts = (collectives.counts(), dispatch.route_counts())
    full = fsdp.full(lay, params) if lay is not None else params
    return {"losses": losses, "params": _np_tree(full), "counts": counts}


def _run_delayed(inputs, cfgs):
    """Pod = this rank: its group's parameters after the delayed steps."""
    from repro_torch import bridge
    from repro_torch.core import delayed_sync
    from repro_torch.distributed import ctx, fsdp
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import optimizers as opt_mod
    ct = cfgs["yi"]
    mesh = mesh_mod.make_mesh((2, 1, 1), "cpu")
    lay = fsdp.layout(ct, mesh, pod_groups=True)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs["yi"]["params"], "cpu"))
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    step = delayed_sync.make_delayed_train_step(
        ct, opt, n_groups=2, merge_interval=2, lr=DELAYED_LR, layout=lay)
    g = dist.get_rank()
    losses = []
    with ctx.use_mesh(mesh):
        for i, bg in enumerate(inputs["delayed_batches"]):
            params, state, met = step(params, state, _tb(bg[g]), i)
            losses.append(float(met["loss"]))
    return {"losses": losses, "params": _np_tree(fsdp.full(lay, params))}


def _run_checkpoint(inputs, cfgs, out_dir):
    """The FSDP save of the bridged parameters (rank 0 writes) and each
    rank's restored shards against the shards it saved."""
    from repro_torch import bridge, checkpoint
    from repro_torch.distributed import fsdp
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = cfgs["yi"]
    mesh = mesh_mod.make_mesh((2, 1), "cpu")
    lay = fsdp.layout(ct, mesh)
    shards = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs["yi"]["params"], "cpu"))
    path = os.path.join(out_dir, "fsdp.npz")
    checkpoint.save(path, shards, lay)
    dist.barrier()
    like = TM.tree_map(torch.zeros_like, shards)
    back = checkpoint.restore(path, like, lay)
    return all(torch.equal(a, b) for a, b in zip(
        TM.flatten(back).values(), TM.flatten(shards).values()))


def _refusals():
    """The errors an undivided batch and a device that does not match the
    group's backend raise."""
    from repro_torch.distributed import collectives
    from repro_torch.launch import train
    out = {}
    os.environ["WORLD_SIZE"] = "2"
    try:
        train.main(["--mode", "llm", "--arch", "yi-6b", "--reduced",
                    "--steps", "1", "--seq", "16", "--batch", "3",
                    "--device", "cpu"])
    except ValueError as e:
        out["batch"] = str(e)
    try:
        collectives.all_reduce(torch.zeros(2, device="meta"), None)
    except ValueError as e:
        out["backend"] = str(e)
    return out


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch import configs as torch_configs
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cfgs = _configs(torch_configs)
        out = {name: _run_case(name, arch, shape, held, inputs, cfgs)
               for name, arch, shape, held in CASES}
        out["delayed"] = _run_delayed(inputs, cfgs)
        out["restored"] = _run_checkpoint(inputs, cfgs, out_dir)
        out["refusals"] = _refusals()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
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
    """JAX's parameters and the batches written for the ranks, the ranks
    started (not joined); the JAX references are computed meanwhile."""
    import jax
    from repro import configs as jax_configs
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("mr")
    cfgs = _configs(jax_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {
            "params": jax.tree.map(np.asarray, pj),
            "batches": [_batch_np(10 + i, cj.vocab_size)
                        for i in range(STEPS)]}
    inputs["delayed_batches"] = [
        [_batch_np(20 + 2 * i + g, cfgs["yi"].vocab_size) for g in range(2)]
        for i in range(STEPS)]
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = mp.spawn(_rank_main, args=(2, _free_port(), str(tmp)), nprocs=2,
                     join=False)
    return procs, tmp, cfgs, inputs


def _jax_flat(cj, tree):
    """The JAX tree in the port's flat layout (layers unstacked)."""
    import jax

    from repro_torch import bridge
    from repro_torch.models import model as TM
    flat = TM.flatten(bridge._unstack(cj, jax.tree.map(np.asarray, tree)))
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's unsharded train step from the same parameters and batches, and
    its delayed step's vmap over two groups."""
    import jax
    import jax.numpy as jnp
    from repro.core import delayed_sync as jax_delayed
    from repro.core import llm_a3c as jax_a3c
    from repro.optim import optimizers as jax_opt
    _, _, cfgs, inputs = setup
    out = {}
    for arch, cj in cfgs.items():
        opt = jax_opt.shared_rmsprop(fused=False)
        step = jax.jit(jax_a3c.make_train_step(cj, opt, lr0=LR0,
                                               total_steps=TOTAL))
        params = jax.tree.map(jnp.asarray, inputs[arch]["params"])
        state = opt.init(params)
        losses = []
        for i, b in enumerate(inputs[arch]["batches"]):
            params, state, met = step(params, state,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()}, jnp.asarray(i))
            losses.append(float(met["loss"]))
        out[arch] = (losses, _jax_flat(cj, params))
    cj = cfgs["yi"]
    opt = jax_opt.shared_rmsprop(fused=False)
    params = jax.tree.map(jnp.asarray, inputs["yi"]["params"])
    pg = jax_delayed.replicate(params, 2)
    og = jax_delayed.replicate(opt.init(params), 2)
    step = jax.jit(jax_delayed.make_delayed_train_step(
        cj, opt, n_groups=2, merge_interval=2, lr=DELAYED_LR))
    for i, bg in enumerate(inputs["delayed_batches"]):
        batch = {k: jnp.stack([jnp.asarray(b[k]) for b in bg])
                 for k in bg[0]}
        pg, og, _ = step(pg, og, batch, jnp.asarray(i))
    out["delayed"] = [_jax_flat(cj, jax.tree.map(lambda a, g=g: a[g], pg))
                      for g in range(2)]
    return out


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    procs, tmp, _, _ = setup
    while not procs.join():
        pass
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _max_err(got, want):
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in got)


@pytest.mark.parametrize("name,arch,shape,held", CASES,
                         ids=[c[0] for c in CASES])
def test_multirank_step_matches_unsharded_jax(ranks, jax_refs, name, arch,
                                              shape, held):
    want_losses, want = jax_refs[arch]
    for r in ranks:
        res = r[name]
        np.testing.assert_allclose(res["losses"], want_losses, rtol=TOL)
        err = _max_err(res["params"], want)
        assert err <= TOL, (name, err)
    # the ranks hold the same parameters and issued the same collectives
    assert _max_err(ranks[0][name]["params"], ranks[1][name]["params"]) \
        == 0.0
    assert ranks[0][name]["counts"] == ranks[1][name]["counts"]
    collective, routes = ranks[0][name]["counts"]
    ct = _case_config(_configs(_torch_configs()), name, arch)
    mesh = dict(zip(("data", "model"), shape))
    lay = _fsdp().layout(ct, mesh) if held == "fsdp" else None
    per_step = _chip_smoke()._step_collectives(ct, lay, mesh)
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    moe = 2 if arch == "granite" else 0
    assert (routes["moe_ep"], routes["moe_dense"]) == (
        STEPS * moe * (1 + ct.remat), 0)


def _torch_configs():
    from repro_torch import configs
    return configs


def _fsdp():
    from repro_torch.distributed import fsdp
    return fsdp


def _chip_smoke():
    """``chip_smoke.py``'s count of the collectives a train step issues,
    which phase 12 gates on the card."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ["yi", "granite"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_step_collectives_count(arch, remat):
    """On one rank, each layout's step issues exactly the collectives
    ``chip_smoke._step_collectives`` counts, with remat (whose recompute
    gathers a block's leaves again) and without: the count phase 12
    gates on the card."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    from repro_torch.optim import optimizers as opt_mod
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=remat)
    b = _tb(_batch_np(0, ct.vocab_size))
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        rules = sharding.activation_rules(mesh, batch_size=B, cfg=ct)
        for held in ("whole", "fsdp"):
            params = TM.init_params(ct, 0, "cpu")
            lay = fsdp.layout(ct, mesh) if held == "fsdp" else None
            if lay is not None:
                params = fsdp.shard(lay, params)
            opt = opt_mod.shared_rmsprop()
            step = llm_a3c.make_train_step(ct, opt, layout=lay)
            collectives.reset_counts()
            dispatch.reset_launch_counts()
            with ctx.use_mesh(mesh), ctx.sharding_rules(rules):
                step(params, opt.init(params), b, 0)
            assert collectives.counts() == _chip_smoke()._step_collectives(
                ct, lay, mesh), (held, remat)
            moe = 2 if arch == "granite" else 0
            assert dispatch.route_counts()["moe_ep"] == moe * (1 + remat)


def test_delayed_sync_over_pods_matches_jax_vmap(ranks, jax_refs):
    for g, r in enumerate(ranks):
        err = _max_err(r["delayed"]["params"], jax_refs["delayed"][g])
        assert err <= TOL, (g, err)
    # the groups drifted apart at step 1 and merged at step 2; step 3
    # parts them again
    a, b = (r["delayed"]["params"] for r in ranks)
    assert _max_err(a, b) > 0.0


def test_fsdp_checkpoint_equals_the_single_process_file(setup, ranks):
    from repro_torch import bridge, checkpoint
    _, tmp, _, inputs = setup
    from repro_torch import configs as torch_configs
    ct = _configs(torch_configs)["yi"]
    params = bridge.params_from_jax(ct, inputs["yi"]["params"], "cpu")
    checkpoint.save(str(tmp / "single.npz"), params)
    with np.load(tmp / "single.npz") as a, np.load(tmp / "fsdp.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    assert all(r["restored"] for r in ranks)


def test_undivided_batch_and_backend_mismatch_raise(ranks):
    for r in ranks:
        assert "does not divide over the 2 ranks" in r["refusals"]["batch"]
        assert "needs a" in r["refusals"]["backend"]


@contextlib.contextmanager
def _partitionable():
    import jax
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_train_cli_over_two_ranks_prints_the_jax_cli_losses(capsys,
                                                            monkeypatch):
    """``--mode llm`` under torchrun over two gloo ranks: one (data 2) mesh,
    each rank on half of each batch; rank 0 prints the losses the JAX CLI
    prints on one device (its multi-device launcher fails on jax 0.9,
    ROADMAP queue 3)."""
    from repro.launch import train as jax_train
    argv = ["--mode", "llm", "--arch", "yi-6b", "--reduced", "--steps", "3",
            "--seq", "32", "--batch", "4", "--seed", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
         "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with _partitionable():
        jax_train.main()
    want = [json.loads(line)["loss"] for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    got = [json.loads(line) for line in out.splitlines()
           if line.startswith("{")]
    assert [r["step"] for r in got] == [0, 1, 2]      # rank 0 alone
    np.testing.assert_allclose([r["loss"] for r in got], want, rtol=TOL)


def test_remat_recompute_keeps_the_forward_route_without_the_rules():
    """The recompute of a remat block takes the route its forward took
    even where the rules are not installed: a card's backward runs on the
    autograd engine's device thread, which does not see the thread-local
    rules, so the block carries the ``moe_ep`` rule as an argument.  Here
    the backward runs after the rules are gone: every MoE layer is routed
    expert-parallel twice (forward and recompute), densely never, and the
    collectives are the counted ones."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = dataclasses.replace(_configs(_torch_configs())["granite"],
                             remat=True)
    b = _tb(_batch_np(1, ct.vocab_size))
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        lay = fsdp.layout(ct, mesh)
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
    assert (routes["moe_ep"], routes["moe_dense"]) == (2 * 2, 0)
    want = _chip_smoke()._step_collectives(ct, lay, mesh)
    got = collectives.counts()
    # a step's counts less its gradient and metric all-reduces
    n_whole = len(lay.held) - want["reduce_scatter"]
    assert got == dict(want, all_reduce=want["all_reduce"] - n_whole - 1)
