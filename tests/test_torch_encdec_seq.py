"""The port's encoder-decoder on the sequence arm with ragged encoder
frames (slice 6b-iv) against the JAX package's unsharded step and
decode, on the CPU over gloo ranks.

Where Whisper's q heads do not divide the model axis (whisper-base's 8 at
16 ranks) every attention takes the sequence arm: the encoder's and the
decoder's self attention attend the rank's rows through the flash
kernels' query-offset arm, and the cross attention takes the rank's
decoder rows against the whole memory with wq and wo gathered and wk, wv
whole.  Where the frames do not divide the axis (1500 at 8 or 16) they
are padded to a multiple of it: rank r holds rows [r Fp / tp, (r + 1) Fp
/ tp), the pad rows zero, and no key, loss or memory row reads them (the
encoder's kernel call takes the rank's valid rows only).

Two worlds run side by side: two ranks on (data 1, model 2), four on
(1, 4).  Reduced Whisper with 3 q / 3 kv heads (the sequence arm; wk and
wv whole) and 29 frames on (1, 2) (shards of 15, the last 14) or 30 on
(1, 4) (shards of 8, the last 6); and on (1, 2) the reduced config's 4
heads with 29 frames (the head arm over padded frames, as whisper-base
at 8 ranks).  Each starts from the JAX package's parameters (``bridge``)
and takes three Shared RMSProp steps, plain and with remat (Whisper has
none, as in the reference: the flag changes nothing): losses and the
whole parameters within ``TOL`` = 1e-5 of JAX's ``make_train_step``; at
one step every leaf's gradient within 1e-5 of ``jax.grad``; each run's
collectives and routes exactly ``chip_smoke._step_collectives`` and
``chip_smoke._mr_routes`` (``tp_frames_pad`` on every encoder layer).
Then ``STEPS`` decode steps under the serving layout over a random f32
cache (the self caches split over the sequence, the cross memory whole
where its rows do not divide the shards): logits within 2e-4 of JAX's
unsharded ``decode_step`` and 2e-5 of the port's own, collectives
exactly ``chip_smoke._decode_collectives``.
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
# (mesh shape, config, the sequence arm)
MESHES = {2: (((1, 2), "w3_29", True), ((1, 2), "w4_29", False)),
          4: (((1, 4), "w3_30", True),)}
ARCHS = ("w3_29", "w4_29", "w3_30")


def _configs(pkg):
    base = pkg.get_config("whisper-base").reduced()
    return {"w3_29": dataclasses.replace(base, n_heads=3, n_kv_heads=3,
                                         encoder_seq=29),
            "w4_29": dataclasses.replace(base, encoder_seq=29),
            "w3_30": dataclasses.replace(base, n_heads=3, n_kv_heads=3,
                                         encoder_seq=30)}


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
    return {"tokens": tokens.astype(np.int32), "rewards": rewards,
            "discounts": (gamma * (1.0 - done)).astype(np.float32),
            "enc_frames": (0.5 * rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)}


def _random_cache(ct):
    """A whole port cache from a seeded normal, numpy f32 {path: array}."""
    from repro_torch.models import model as TM
    cache = TM.init_cache(ct, B, L, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(ct.encoder_seq)
    return {p: (0.5 * rng.standard_normal(t.shape)).astype(np.float32)
            for p, t in TM.flatten(cache).items() if torch.is_tensor(t)}


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


def _layout(ct, mesh, seq, serve=False):
    from repro_torch.distributed import fsdp
    lay = (fsdp.serve_layout if serve else fsdp.layout)(ct, mesh)
    assert lay.tp and lay.seq == seq
    return lay


def _run_case(ct, mesh, inputs, arch, seq):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.optim import optimizers as opt_mod
    lay = _layout(ct, mesh, seq)
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


def _grads_once(ct, mesh, inputs, arch, seq):
    from repro_torch import bridge
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import fsdp, sharding
    lay = _layout(ct, mesh, seq)
    params = fsdp.shard(lay, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    with _scope(mesh, ct):
        grads, met = llm_a3c.loss_grads(
            ct, params, sharding.shard_batch(
                mesh, _tb(inputs[arch]["batches"][0])), layout=lay)
    return {"loss": float(met["loss"]),
            "grads": _np_tree(fsdp.full(lay, grads))}


def _port_cache(ct, flat):
    from repro_torch.models import model as TM
    cache = TM.init_cache(ct, B, L, dtype=torch.float32, device="cpu")
    for path, t in TM.flatten(cache).items():
        if path in flat:
            t.copy_(torch.from_numpy(flat[path]))
    return cache


def _decode_case(ct, mesh, inputs, arch, seq):
    """``STEPS`` decode steps under the serving layout over the random
    cache, beside the port's unsharded decode: each rank's rows."""
    from repro_torch import bridge
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as TM
    lay = _layout(ct, mesh, seq, serve=True)
    whole = TM.cast_params(ct, bridge.params_from_jax(
        ct, inputs[arch]["params"], "cpu"))
    shards = fsdp.shard(lay, whole)
    rules = sharding.decode_rules(ct, mesh, batch_size=B)
    axes = tuple(rules["decode_cp"]["dp_axes"])
    n = sharding.axes_size(mesh, axes)
    r = sharding.axes_rank(mesh, axes) if axes else 0
    rows = slice(r * (B // n), (r + 1) * (B // n))
    flat = inputs[arch]["cache"]
    plain = _port_cache(ct, flat)
    cache = fsdp.shard_cache(ct, mesh, _port_cache(ct, flat), batch_size=B)
    inp = inputs[arch]["decode"]
    out = {"logits": [], "plain": [], "counts": [], "rows": (rows.start,
                                                             rows.stop),
           "cross_split": "global_len" in cache["cross"][0]}
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
        for shape, arch, seq in MESHES[world]:
            mesh = mesh_mod.make_mesh(shape, "cpu")
            for remat in (False, True):
                ct = dataclasses.replace(cfgs[arch], remat=remat)
                out[(arch, remat)] = _run_case(ct, mesh, inputs, arch, seq)
            out[(arch, "grads")] = _grads_once(cfgs[arch], mesh, inputs,
                                               arch, seq)
            out[(arch, "decode")] = _decode_case(cfgs[arch], mesh, inputs,
                                                 arch, seq)
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
    """JAX's parameters, the batches, the random caches and the decode
    tokens written for the ranks, both worlds started (not joined)."""
    import jax
    from repro import configs as jax_configs
    from repro.models import model as JM
    from repro_torch import configs as torch_configs
    tmp = tmp_path_factory.mktemp("encdecseq")
    cfgs = _configs(jax_configs)
    ct = _configs(torch_configs)
    inputs = {}
    for arch, cj in cfgs.items():
        pj = JM.init_params(cj, jax.random.key(0))
        inputs[arch] = {"params": jax.tree.map(np.asarray, pj),
                        "batches": [_batch_np(10 + i, cj)
                                    for i in range(STEPS)],
                        "cache": _random_cache(ct[arch]),
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


def _jax_cache(cj, flat):
    """The JAX package's cache holding the port cache ``flat``'s values."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cache = JM.init_cache(cj, B, L, dtype=jnp.float32)

    def fill(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if keys[-1] == "index":
            return leaf
        a = flat[".".join(str(k) for k in keys)]
        assert a.shape == leaf.shape, (keys, a.shape, leaf.shape)
        return jnp.asarray(a, leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, cache)


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
        cache = _jax_cache(cj, inputs[arch]["cache"])
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


def _mesh(shape):
    return dict(zip(("data", "model"), shape))


CASES = [(w, s, a, q, r) for w in MESHES for s, a, q in MESHES[w]
         for r in (False, True)]


@pytest.mark.parametrize("world,shape,arch,seq,remat", CASES, ids=[
    f"{'x'.join(map(str, s))}-{a}-{'remat' if r else 'plain'}"
    for w, s, a, q, r in CASES])
def test_ragged_step_matches_unsharded_jax(ranks, jax_refs, world, shape,
                                           arch, seq, remat):
    want = jax_refs[arch]
    res = [r[(arch, remat)] for r in ranks[world]]
    for got in res:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        err = _max_err(got["params"], want["params"])
        assert err <= TOL, (arch, remat, err)
    for got in res[1:]:
        assert _max_err(got["params"], res[0]["params"]) == 0.0
        assert got["counts"] == res[0]["counts"]
    collective, routes = res[0]["counts"]
    ct = dataclasses.replace(_torch_cfgs()[arch], remat=remat)
    lay = _layout(ct, _mesh(shape), seq)
    cs = _chip_smoke()
    per_step = cs._step_collectives(ct, lay, _mesh(shape))
    assert collective == {k: STEPS * v for k, v in per_step.items()}
    want_r = cs._mr_routes(ct, lay)
    assert {k: routes[k] for k in want_r} == \
        {k: STEPS * v for k, v in want_r.items()}
    assert routes["tp_frames_pad"] == STEPS * ct.encoder_layers
    assert routes["tp_seq"] == STEPS * (ct.encoder_layers +
                                        ct.n_layers) * seq


@pytest.mark.parametrize("world,shape,arch,seq", [
    (w, s, a, q) for w in MESHES for s, a, q in MESHES[w]])
def test_every_leaf_gradient_matches_jax_at_one_step(ranks, jax_refs, world,
                                                     shape, arch, seq):
    want = jax_refs[arch]
    for r in ranks[world]:
        got = r[(arch, "grads")]
        np.testing.assert_allclose(got["loss"], want["loss0"], rtol=TOL)
        for k, g in want["grads"].items():
            scale = max(1.0, float(np.abs(g).max()))
            np.testing.assert_allclose(got["grads"][k], g, rtol=TOL,
                                       atol=TOL * scale, err_msg=k)


@pytest.mark.parametrize("world,shape,arch,seq", [
    (w, s, a, q) for w in MESHES for s, a, q in MESHES[w]])
def test_ragged_decode_matches_unsharded_jax(ranks, jax_refs, world, shape,
                                             arch, seq):
    want = jax_refs[arch]["logits"]
    res = [r[(arch, "decode")] for r in ranks[world]]
    ct = _torch_cfgs()[arch]
    lay = _layout(ct, _mesh(shape), seq, serve=True)
    cs = _chip_smoke()
    want_c = cs._decode_collectives(ct, lay, cross_owned=False)
    for got in res:
        # the cross memory's rows do not divide the shards: held whole
        assert not got["cross_split"]
        lo, hi = got["rows"]
        for i in range(STEPS):
            err = float(np.abs(got["logits"][i] - want[i][lo:hi]).max())
            assert err <= DECODE_TOL, (i, err)
            err = float(np.abs(got["logits"][i] - got["plain"][i]).max())
            assert err <= LAYOUT_TOL, (i, err)
        for coll, routes in got["counts"]:
            assert coll == want_c, (coll, want_c)
            arm = "tp_decode_cols" if seq else "tp_decode_heads"
            assert routes[arm] == ct.n_layers
            assert routes["tp_cross"] == ct.n_layers


@pytest.mark.parametrize("tp,seq,rows,last", [(8, False, 188, 184),
                                              (16, True, 94, 90)])
def test_whisper_base_frames_pad_over_the_model_axis(tp, seq, rows, last):
    """whisper-base's 1500 frames over 8 and 16 model ranks: padded to
    1504, the last rank's valid rows fewer; at 16 its 8 q and kv heads
    take the sequence arm, wk and wv of every attention (encoder, decoder
    self and cross) held whole, wq's columns and wo's rows split; nothing
    is refused."""
    from repro_torch import configs
    from repro_torch.distributed import fsdp, sharding
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec
    cfg = configs.get_config("whisper-base")
    mesh = {"data": 1, "model": tp}
    assert not sharding.tp_refusal(cfg, mesh)
    lay = fsdp.layout(cfg, mesh)
    assert lay.tp and lay.seq == seq
    rule = fsdp.TPRule(None, tp, tp - 1, False, seq)
    assert encdec.frame_rows(1500, rule) == rows
    assert attn.ragged_rows(1500, rows, tp - 1) == last
    assert attn.ragged_rows(1500, rows, 0) == rows
    for sub in ("enc_layers.0.attn", "dec_layers.0.self_attn",
                "dec_layers.0.cross_attn"):
        for name in ("wk.w", "wv.w", "wk.b"):
            assert lay.sharded(f"{sub}.{name}", "model") == (not seq), name
        assert lay.sharded(f"{sub}.wq.w", "model")
        assert lay.sharded(f"{sub}.wo.w", "model")
    with pytest.raises(ValueError, match="too few rows"):
        attn.ragged_rows(5, 2, 3)
