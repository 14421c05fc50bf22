"""The port's head-split arm of the xLSTM blocks (slice 6b-iv) against the
JAX package's unsharded step and decode, on the CPU over gloo ranks.

Where the model axis is wider than the xLSTM heads and a multiple of
them (xlstm-1.3b's 4 heads at 8 or 16 ranks) each head is split over g =
tp / H ranks: rank r works on head r // g and owns a g-th of its
features.  The mLSTM gathers its q and k columns along the features and
keeps v, C's rows and y on its own; the sLSTM gathers its head's
pre-activations once a layer and runs the head's whole recurrence with
``r[h]`` held whole on the head's g ranks (``sharding.Grouped``).  The
redundant parts' gradients are partial on each rank and are summed once
over the model group.

Two worlds run side by side: two ranks on (data 1, model 2) with one
head (g = 2), four on (1, 4) with two heads (g = 2) and on (2, 2) with
one (g = 2, FSDP over data as well).  Reduced xlstm on the ("mlstm",
"slstm") cycle, started from the JAX package's parameters (``bridge``):
three Shared RMSProp steps with remat and without, losses and the whole
parameters within ``TOL`` = 1e-5 of JAX's ``make_train_step``; at one
step every leaf's gradient within 1e-5 of ``jax.grad`` in relative L2
(see the test); each run's
collectives and routes exactly ``chip_smoke._step_collectives`` and
``chip_smoke._mr_routes`` (``tp_lstm_split`` on every xLSTM layer, again
in the remat recompute).  Then ``STEPS`` decode steps under the serving
layout from the initial state: logits within 2e-4 of JAX's unsharded
``decode_step`` and 2e-5 of the port's own (the tolerances of
``test_torch_decode_layout_cols.py``), collectives exactly
``chip_smoke._decode_collectives``.  Also the arm forced on one rank
(``force_head_split``) against the unsharded step, and the plan at the
production widths.
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
DECODE_TOL = 2e-4
LAYOUT_TOL = 2e-5
L = 16
# (mesh shape, config): g = tp / heads = 2 on each
MESHES = {2: (((1, 2), "x1"),), 4: (((1, 4), "x2"), ((2, 2), "x1"))}
ARCHS = ("x1", "x2")


def _configs(pkg):
    """Reduced xlstm with 1 and 2 heads, d_model cut to keep the reduced
    config's per-head width (an mLSTM head of 128 features, an sLSTM head
    of 64): at d_model 256 with 1 or 2 heads the port's unsharded step
    itself is off JAX's by up to 2.5e-3 (1 head) and 3.8e-5 (2 heads) of
    a leaf's largest gradient, wider heads' normaliser n . q summing more
    terms to near zero, so a 1e-5 comparison could not tell the layout
    from that rounding."""
    base = dataclasses.replace(pkg.get_config("xlstm-1.3b").reduced(),
                               block_cycle=("mlstm", "slstm"))
    return {"x1": dataclasses.replace(base, n_heads=1, n_kv_heads=1,
                                      d_model=64),
            "x2": dataclasses.replace(base, n_heads=2, n_kv_heads=2,
                                      d_model=128)}


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


def _decode_np(vocab):
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32),
            "pos0": np.asarray([2, 5, 8, 11], np.int32)}


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


def _layout(ct, mesh, serve=False):
    from repro_torch.distributed import fsdp
    lay = (fsdp.serve_layout if serve else fsdp.layout)(ct, mesh)
    assert lay.tp and lay.head_split == 2
    return lay


def _run_case(ct, mesh, inputs, arch):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.optim import optimizers as opt_mod
    lay = _layout(ct, mesh)
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
    lay = _layout(ct, mesh)
    whole = bridge.params_from_jax(ct, inputs[arch]["params"], "cpu")
    b0 = _tb(inputs[arch]["batches"][0])
    with _scope(mesh, ct):
        grads, met = llm_a3c.loss_grads(
            ct, fsdp.shard(lay, whole), sharding.shard_batch(mesh, b0),
            layout=lay)
    return {"loss": float(met["loss"]),
            "grads": _np_tree(fsdp.full(lay, grads))}


def _decode_case(ct, mesh, inputs, arch):
    """``STEPS`` decode steps under the serving layout from the initial
    state, beside the port's unsharded decode: each rank's rows."""
    from repro_torch import bridge
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as TM
    lay = _layout(ct, mesh, serve=True)
    whole = TM.cast_params(ct, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    shards = fsdp.shard(lay, whole)
    rules = sharding.decode_rules(ct, mesh, batch_size=B)
    axes = tuple(rules["decode_cp"]["dp_axes"])
    n = sharding.axes_size(mesh, axes)
    r = sharding.axes_rank(mesh, axes) if axes else 0
    rows = slice(r * (B // n), (r + 1) * (B // n))
    plain = TM.init_cache(ct, B, L, dtype=torch.float32, device="cpu")
    cache = fsdp.shard_cache(ct, mesh, TM.init_cache(
        ct, B, L, dtype=torch.float32, device="cpu"), batch_size=B)
    inp = inputs[arch]["decode"]
    out = {"logits": [], "plain": [], "counts": [], "rows": (rows.start,
                                                             rows.stop)}
    with ctx.use_mesh(mesh), ctx.sharding_rules(rules):
        pos = torch.from_numpy(inp["pos0"][rows])
        for i in range(STEPS):
            collectives.reset_counts()
            dispatch.reset_launch_counts()
            o, _ = TM.decode_step(ct, shards, cache, {
                "tokens": torch.from_numpy(inp["tokens"][i][rows]).long()},
                pos, layout=lay)
            out["counts"].append((collectives.counts(),
                                  dispatch.route_counts()))
            out["logits"].append(o["logits"][:, -1].float().numpy())
            with ctx.sharding_rules(None):
                o, _ = TM.decode_step(ct, whole, plain, {
                    "tokens": torch.from_numpy(inp["tokens"][i]).long()},
                    torch.from_numpy(inp["pos0"] + i))
            out["plain"].append(o["logits"][rows, -1].float().numpy())
            pos = pos + 1
    return out


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
        for shape, arch in MESHES[world]:
            mesh = mesh_mod.make_mesh(shape, "cpu")
            for remat in (False, True):
                ct = dataclasses.replace(cfgs[arch], remat=remat)
                out[(shape, remat)] = _run_case(ct, mesh, inputs, arch)
            out[(shape, "grads")] = _grads_once(cfgs[arch], mesh, inputs,
                                                arch)
            out[(shape, "decode")] = _decode_case(cfgs[arch], mesh, inputs,
                                                  arch)
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
    """JAX's parameters, the batches and the decode tokens written for the
    ranks, both worlds started (not joined)."""
    import jax
    from repro import configs as jax_configs
    from repro.models import model as JM
    tmp = tmp_path_factory.mktemp("tpheads")
    cfgs = _configs(jax_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {"params": jax.tree.map(np.asarray, pj),
                        "batches": [_batch_np(10 + i, cj.vocab_size)
                                    for i in range(STEPS)],
                        "decode": _decode_np(cj.vocab_size)}
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
    """JAX's unsharded train step, its gradients at step 0 and its decode
    logits, from the same parameters and inputs."""
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
        dec = inputs[arch]["decode"]
        cache = JM.init_cache(cj, B, L, dtype=jnp.float32)
        logits = []
        for i in range(STEPS):
            o, cache = JM.decode_step(cj, params, cache, {
                "tokens": jnp.asarray(dec["tokens"][i])},
                jnp.asarray(dec["pos0"] + i))
            logits.append(np.asarray(o["logits"][:, -1], np.float64))
        state = opt.init(params)
        losses = []
        for i, b in enumerate(inputs[arch]["batches"]):
            params, state, met = step(params, state,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()}, jnp.asarray(i))
            losses.append(float(met["loss"]))
        out[arch] = {"losses": losses, "params": _jax_flat(cj, params),
                     "loss0": float(loss0), "grads": _jax_flat(cj, g0),
                     "logits": logits}
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


def _torch_cfgs():
    from repro_torch import configs
    return _configs(configs)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


CASES = [(w, s, a, r) for w in MESHES for s, a in MESHES[w]
         for r in (False, True)]


@pytest.mark.parametrize("world,shape,arch,remat", CASES, ids=[
    f"{'x'.join(map(str, s))}-{a}-{'remat' if r else 'plain'}"
    for w, s, a, r in CASES])
def test_head_split_step_matches_unsharded_jax(ranks, jax_refs, world, shape,
                                               arch, remat):
    want = jax_refs[arch]
    res = [r[(shape, remat)] for r in ranks[world]]
    for got in res:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        err = _max_err(got["params"], want["params"])
        assert err <= TOL, (arch, remat, err)
    for got in res[1:]:
        assert _max_err(got["params"], res[0]["params"]) == 0.0
        assert got["counts"] == res[0]["counts"]
    collective, routes = res[0]["counts"]
    ct = dataclasses.replace(_torch_cfgs()[arch], remat=remat)
    mesh = dict(zip(("data", "model"), shape))
    lay = _layout(ct, mesh)
    cs = _chip_smoke()
    per_step = cs._step_collectives(ct, lay, mesh)
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    want_r = cs._mr_routes(ct, lay)
    assert {k: routes[k] for k in want_r} == \
        {k: STEPS * v for k, v in want_r.items()}
    assert routes["tp_lstm_split"] == STEPS * ct.n_layers * (1 + remat)


@pytest.mark.parametrize("world,shape,arch", [(w, s, a) for w in MESHES
                                              for s, a in MESHES[w]])
def test_every_leaf_gradient_matches_jax_at_one_step(ranks, jax_refs, world,
                                                     shape, arch):
    """At one step the loss within 1e-5 of JAX's, and every leaf's
    gradient within 1e-5 of ``jax.grad``'s in L2, relative to the leaf's
    norm (or 1, for a small one): a partial gradient of a redundant part
    dropped or counted g times would be off by a whole share.  Element by
    element the port's unsharded gradients of these 1- and 2-head configs
    already differ from ``jax.grad``'s by up to 1.8e-5 of a leaf's
    largest, at the few rows where the mLSTM's normaliser n . q sums to
    near zero (f32 rounding in either framework's order), and any
    reordering of those sums (the head split's) moves such an element by
    as much, so the elements are not held one by one."""
    want = jax_refs[arch]
    for r in ranks[world]:
        got = r[(shape, "grads")]
        np.testing.assert_allclose(got["loss"], want["loss0"], rtol=TOL)
        assert set(got["grads"]) == set(want["grads"])
        for k, j in want["grads"].items():
            dist_l2 = float(np.linalg.norm(got["grads"][k] - j))
            assert dist_l2 <= TOL * max(1.0, float(np.linalg.norm(j))), \
                (k, dist_l2)


@pytest.mark.parametrize("world,shape,arch", [(w, s, a) for w in MESHES
                                              for s, a in MESHES[w]])
def test_head_split_decode_matches_unsharded_jax(ranks, jax_refs, world,
                                                 shape, arch):
    want = jax_refs[arch]["logits"]
    res = [r[(shape, "decode")] for r in ranks[world]]
    ct = _torch_cfgs()[arch]
    lay = _layout(ct, dict(zip(("data", "model"), shape)), serve=True)
    want_c = _chip_smoke()._decode_collectives(ct, lay)
    for got in res:
        lo, hi = got["rows"]
        for i in range(STEPS):
            err = float(np.abs(got["logits"][i] - want[i][lo:hi]).max())
            assert err <= DECODE_TOL, (i, err)
            err = float(np.abs(got["logits"][i] - got["plain"][i]).max())
            assert err <= LAYOUT_TOL, (i, err)
        for coll, routes in got["counts"]:
            assert coll == want_c, (coll, want_c)
            assert routes["tp_lstm_split"] == ct.n_layers
            assert routes["tp_lstm_heads"] == ct.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_head_split_on_one_rank_is_the_unsharded_step(arch):
    """``fsdp.layout(force_head_split=True)`` over a (1, 1) mesh runs the
    arm's code with g = 1 (q and k gathered along the features, the
    sLSTM's pre-activations gathered, r's padded sum) on a group of one:
    the loss and every gradient equal the unsharded step's exactly, with
    remat, and the recompute takes the arm again."""
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as TM
    ct = dataclasses.replace(_torch_cfgs()[arch], remat=True)
    b = _tb(_batch_np(1, ct.vocab_size))
    params = TM.init_params(ct, 0, "cpu")
    want, _ = llm_a3c.loss_grads(ct, params, b)
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        lay = fsdp.layout(ct, mesh, force_head_split=True)
        assert lay.tp and lay.head_split == 1
        dispatch.reset_launch_counts()
        got, _ = llm_a3c.loss_grads(ct, fsdp.shard(lay, params), b,
                                    layout=lay)
        routes = dispatch.route_counts()
    want, got = TM.flatten(want), TM.flatten(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert routes["tp_lstm_split"] == 2 * ct.n_layers


@pytest.mark.parametrize("tp,g", [(8, 2), (16, 4)])
def test_production_widths_split_each_head_over_g_ranks(tp, g):
    """xlstm-1.3b's 4 heads over 8 and 16 model ranks: the layout takes
    the head-split arm; every planned "model" entry is held, the sLSTM's
    ``r`` a head a rank (``Grouped``), and a rank's shard of it is head
    r // g; the decode states follow (``cache_shardings``), and a width
    no arm covers (4 heads over 6 ranks) is refused."""
    from repro_torch import configs
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.models import model as TM
    cfg = configs.get_config("xlstm-1.3b")
    mesh = {"data": 1, "model": tp}
    assert sharding.head_split(cfg, mesh) == g
    assert not sharding.tp_refusal(cfg, mesh)
    lay = fsdp.layout(cfg, mesh)
    assert lay.head_split == g
    holds = sharding.tp_holds(cfg, mesh)
    assert holds and all(holds.values())
    splits = sharding.tp_splits(cfg, mesh)
    r_path = next(p for p in splits if p.endswith("slstm.r"))
    assert splits[r_path] == sharding.TPSplit("grouped", 0, plan_dim=2, g=g)
    assert lay.held[r_path][0] == sharding.Grouped("model", g)
    assert sharding.entry_parts(mesh, lay.held[r_path][0]) == 4
    cache = TM.init_cache(dataclasses.replace(cfg, n_layers=8), 2, 8,
                          device="meta")
    specs = sharding.cache_shardings(cfg, mesh, cache, batch_size=2)
    assert specs["layers.0.C"][1:3] == (sharding.Grouped("model", g),
                                       sharding.Grouped("model", g, True))
    assert specs["layers.0.n"][1] == sharding.Grouped("model", g)
    assert specs["layers.7.h"][1] == sharding.Grouped("model", g)
    assert specs["layers.0.conv"][2] == "model"
    with pytest.raises(ValueError, match="mLSTM/sLSTM heads 4 does not "
                                         "divide the 6-way"):
        fsdp.layout(cfg, {"data": 1, "model": 6})
