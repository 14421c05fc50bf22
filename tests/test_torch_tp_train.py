"""The port's tensor- and sequence-parallel train step (slice 6b-i) against
the JAX package's unsharded one, on the CPU over gloo ranks.

Two worlds run side by side: two ranks on (data 1, model 2) and four on
(data 2, model 2) (FSDP over data as well).  Each case starts from the
JAX package's parameters (``bridge``) held as ``fsdp.layout`` holds them
under tensor parallelism (heads, d_ff columns and vocab rows split over
the model axis) and takes three Shared RMSProp steps on the same numpy
batches, every rank on its data rows and its half of the sequence: reduced
yi-6b (one kv head: the whole-kv arm), stablelm-1.6b (layernorm, partial
rotary), qwen2-72b (qkv bias on a whole kv head), minicpm-2b with an odd
vocab (511: the tied table held whole, the logits whole) and granite-moe
(tied vocab-parallel table; experts expert-parallel on the sequence rows,
capacity factor 4.0 and ``aux_loss_weight`` 0 so nothing drops), each with
remat and without.  The parameters, gathered whole, and the losses are
held to JAX's unsharded ``make_train_step`` within 1e-5 (remat does not
change the function, so one JAX run serves both).  The vocab-parallel
loss sums the vocab in another order than ``log_softmax``: the two agree
to rounding, which 1e-5 covers, not bit for bit.

Also, at one step, every leaf's gradient (``loss_grads``, gathered whole)
against ``jax.grad`` of the reference's ``a3c_token_loss``; a qwen2-vl
forward with (3, B, S) M-RoPE positions (logits gathered over the vocab,
values) against the reference's; each run's collectives exactly
``chip_smoke._step_collectives`` and its routes (local heads on every
layer, norms on the sequence rows, whole kv heads where they do not
divide); a checkpoint of model-sharded parameters that equals the
single-process file bit for bit and restores each rank's shards; the
remat recompute keeping the tensor-parallel route outside the rules; the
expert-parallel experts taken from the layout without the rules; and the
layouts this slice refuses, each a ValueError.
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
ARCHS = ("yi", "stablelm", "qwen2", "minicpm", "granite")
MESHES = {2: (1, 2), 4: (2, 2)}


def _configs(pkg):
    r = {a: pkg.get_config(n).reduced() for a, n in (
        ("yi", "yi-6b"), ("stablelm", "stablelm-1.6b"),
        ("qwen2", "qwen2-72b"), ("qwen2vl", "qwen2-vl-72b"))}
    r["minicpm"] = dataclasses.replace(
        pkg.get_config("minicpm-2b").reduced(), vocab_size=511)
    r["granite"] = dataclasses.replace(
        pkg.get_config("granite-moe-1b-a400m").reduced(),
        capacity_factor=4.0, aux_loss_weight=0.0)
    return r


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


def _positions(seed):
    """M-RoPE (3, B, S) positions: text rows count up on all three axes,
    then an image patch grid of 4 x 4 at one temporal index."""
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    start = rng.integers(0, S - 16, B)
    for b, s0 in enumerate(start):
        pos[0, b, s0:s0 + 16] = s0
        pos[1, b, s0:s0 + 16] = s0 + np.repeat(np.arange(4), 4)
        pos[2, b, s0:s0 + 16] = s0 + np.tile(np.arange(4), 4)
    return pos.astype(np.int32)


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
            "counts": counts}


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


def _qwen2vl_forward(ct, mesh, inputs):
    from repro_torch import bridge
    from repro_torch.distributed import collectives, fsdp, sharding
    from repro_torch.models import model as TM
    lay = fsdp.layout(ct, mesh)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs["qwen2vl"]["params"], "cpu"))
    batch = _tb(inputs["qwen2vl"]["batches"][0])
    batch["positions"] = torch.from_numpy(inputs["qwen2vl"]["positions"])
    with _scope(mesh, ct), torch.no_grad():
        out = TM.forward(ct, params, sharding.shard_batch(mesh, batch), lay)
        logits = collectives.all_gather(out["logits"], sharding.axes_group(
            mesh, ("model",)), 2)
    return {"logits": logits.numpy(), "value": out["value"].numpy()}


def _checkpoint(ct, mesh, inputs, out_dir, world):
    from repro_torch import bridge, checkpoint
    from repro_torch.distributed import fsdp
    from repro_torch.models import model as TM
    lay = fsdp.layout(ct, mesh)
    shards = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs["yi"]["params"], "cpu"))
    path = os.path.join(out_dir, f"tp{world}.npz")
    checkpoint.save(path, shards, lay)
    dist.barrier()
    back = checkpoint.restore(path, TM.tree_map(torch.zeros_like, shards),
                              lay)
    return all(torch.equal(a, b) for a, b in zip(
        TM.flatten(back).values(), TM.flatten(shards).values()))


def _refusals(cfgs, mesh, inputs):
    """The layouts and inputs this slice refuses."""
    from repro_torch import configs as torch_configs
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.models import model as TM
    out = {}
    try:
        fsdp.layout(torch_configs.get_config("zamba2-1.2b").reduced(), mesh,
                    force_tp=True)
    except ValueError as e:
        out["zamba2"] = str(e)
    ct = cfgs["yi"]
    lay = fsdp.layout(ct, mesh)
    params = fsdp.shard(lay, TM.init_params(ct, 0, "cpu"))
    odd = {"tokens": torch.zeros((B, S - 1), dtype=torch.long)}
    try:
        with _scope(mesh, ct):
            TM.forward(ct, params, sharding.shard_batch(mesh, odd), lay)
    except ValueError as e:
        out["seq"] = str(e)
    return out


def _experts_without_rules(cfgs, mesh, inputs):
    """Granite's tensor-parallel forward with the rules installed and
    without: the layout, not the rules, picks the expert-parallel
    experts."""
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as TM
    ct = cfgs["granite"]
    lay = fsdp.layout(ct, mesh)
    params = fsdp.shard(lay, TM.init_params(ct, 0, "cpu"))
    batch = sharding.shard_batch(mesh, _tb(inputs["granite"]["batches"][0]))
    with torch.no_grad():
        with _scope(mesh, ct):
            want = TM.forward(ct, params, batch, lay)
        dispatch.reset_launch_counts()
        got = TM.forward(ct, params, batch, lay)
    return {"routes": dispatch.route_counts(),
            "equal": all(torch.equal(torch.as_tensor(got[k]),
                                     torch.as_tensor(want[k]))
                         for k in want)}


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
        out["qwen2vl"] = _qwen2vl_forward(cfgs["qwen2vl"], mesh, inputs)
        out["restored"] = _checkpoint(cfgs["yi"], mesh, inputs, out_dir,
                                      world)
        out["refusals"] = _refusals(cfgs, mesh, inputs)
        out["experts"] = _experts_without_rules(cfgs, mesh, inputs)
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
    tmp = tmp_path_factory.mktemp("tpt")
    cfgs = _configs(jax_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {"params": jax.tree.map(np.asarray, pj),
                        "batches": [_batch_np(10 + i, cj.vocab_size)
                                    for i in range(STEPS)]}
    inputs["qwen2vl"]["positions"] = _positions(5)
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
    """JAX's unsharded train step, its gradients at step 0 and the qwen2-vl
    forward, from the same parameters and batches."""
    import jax
    import jax.numpy as jnp
    from repro.core import llm_a3c as jax_a3c
    from repro.models import model as JM
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
    cj = cfgs["qwen2vl"]
    batch = {"tokens": jnp.asarray(inputs["qwen2vl"]["batches"][0]["tokens"]),
             "positions": jnp.asarray(inputs["qwen2vl"]["positions"])}
    fwd = JM.forward(cj, jax.tree.map(jnp.asarray,
                                      inputs["qwen2vl"]["params"]), batch)
    out["qwen2vl"] = {"logits": np.asarray(fwd["logits"], np.float32),
                      "value": np.asarray(fwd["value"], np.float32)}
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
    from repro_torch.distributed import fsdp
    want = jax_refs[arch]
    res = ranks[world]
    for r in res:
        got = r[(arch, remat)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        err = _max_err(got["params"], want["params"])
        assert err <= TOL, (arch, remat, err)
    # every rank holds the same whole parameters and issued the same
    # collectives: exactly the count phase 12 gates on the card
    for r in res[1:]:
        assert _max_err(r[(arch, remat)]["params"],
                        res[0][(arch, remat)]["params"]) == 0.0
        assert r[(arch, remat)]["counts"] == res[0][(arch, remat)]["counts"]
    collective, routes = res[0][(arch, remat)]["counts"]
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=remat)
    mesh = dict(zip(("data", "model"), MESHES[world]))
    lay = fsdp.layout(ct, mesh)
    per_step = _chip_smoke()._step_collectives(ct, lay, mesh)
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    layers, passes = ct.n_layers, 1 + remat
    kv_whole = ct.n_kv_heads % 2 != 0
    assert routes["tp_heads"] == STEPS * layers * passes
    assert routes["tp_kv_whole"] == STEPS * layers * passes * kv_whole
    assert routes["sp_rows"] == STEPS * (2 * layers * passes + 1)
    moe = layers * passes * STEPS if ct.n_experts else 0
    assert (routes["moe_ep"], routes["moe_dense"]) == (moe, 0)


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
def test_qwen2vl_forward_with_mrope_positions(ranks, jax_refs, world):
    want = jax_refs["qwen2vl"]
    m = MESHES[world]
    for rank, r in enumerate(ranks[world]):
        rows = B // m[0]
        d = rank // m[1]
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(r["qwen2vl"]["logits"],
                                   want["logits"][sl], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["qwen2vl"]["value"], want["value"][sl],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", list(MESHES))
def test_model_sharded_checkpoint_equals_the_single_process_file(
        setup, ranks, world):
    from repro_torch import bridge, checkpoint
    _, tmp, _, inputs = setup
    ct = _configs(_torch_configs())["yi"]
    params = bridge.params_from_jax(ct, inputs["yi"]["params"], "cpu")
    checkpoint.save(str(tmp / f"single{world}.npz"), params)
    with np.load(tmp / f"single{world}.npz") as a, \
            np.load(tmp / f"tp{world}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    assert all(r["restored"] for r in ranks[world])


@pytest.mark.parametrize("world", list(MESHES))
def test_refused_layouts_raise(ranks, world):
    for r in ranks[world]:
        got = r["refusals"]
        assert "6b-ii" in got["zamba2"]
        assert "does not divide over the 2 model ranks" in got["seq"]


@pytest.mark.parametrize("world", list(MESHES))
def test_tp_experts_follow_the_layout_without_the_rules(ranks, world):
    """Under tensor parallelism the expert-parallel rule comes from the
    layout (``fsdp.ep_rule``): a forward without the installed rules routes
    every MoE layer expert-parallel and equals the one with them."""
    n = _configs(_torch_configs())["granite"].n_layers
    for r in ranks[world]:
        got = r["experts"]
        assert got["equal"]
        assert (got["routes"]["moe_ep"], got["routes"]["moe_dense"]) == (n, 0)


@pytest.mark.parametrize("arch", ["yi", "granite"])
def test_remat_recompute_keeps_the_tp_route_without_the_rules(arch):
    """The recompute of a remat block takes the tensor-parallel route its
    forward took even where the rules are not installed (a card's backward
    runs on the autograd engine's device thread, which does not see the
    thread-local rules): on a one-rank (1, 1) mesh with tensor parallelism
    asked for, the backward runs after the rules are gone and every layer
    still attends on local heads and normalises the sequence rows twice,
    and the collectives are the counted ones less the gradient and metric
    all-reduces of ``loss_grads``."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = dataclasses.replace(_configs(_torch_configs())[arch], remat=True)
    b = _tb(_batch_np(1, ct.vocab_size))
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
    n = ct.n_layers
    assert routes["tp_heads"] == 2 * n
    assert routes["sp_rows"] == 2 * 2 * n + 1
    assert routes["moe_ep"] == (2 * n if ct.n_experts else 0)
    want = _chip_smoke()._step_collectives(ct, lay, mesh)
    n_whole = len(lay.held) - want["reduce_scatter"] + \
        _chip_smoke()._tp_collectives(ct, lay)["reduce_scatter"]
    assert collectives.counts() == dict(
        want, all_reduce=want["all_reduce"] - n_whole - 1)
