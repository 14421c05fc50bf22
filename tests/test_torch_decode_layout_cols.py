"""The port's decode under the serving layout for q heads that do not
divide the model axis (slice 6b-iii: the column arm) against the JAX
package's unsharded decode, on the CPU over gloo ranks.

There the serving layout holds wq (and wk, wv where their heads divide)
as the plan's contiguous column split and wo as its row split, off head
boundaries: each rank projects its columns without RoPE, one all-gather
along the features collects q | k | v, the heads are split and rotated,
kernel 7 runs on every head over the rank's sequence shard with the
combine as before, and the rank's columns of the output meet its rows of
wo, summed over the model group (``attention._qkv_cols``; the
``tp_decode_cols`` route).

Two worlds run side by side: two ranks on (data 1, model 2), four on
(1, 4) and (2, 2).  The configs of ``test_torch_tp_seq_train.py``: a
minicpm-like MHA config (3 / 3 heads), a scout-like GQA MoE config (5 q
/ 1 kv head, wk and wv whole; ``attn_local`` layers on an 8-row ring),
and stablelm with the arm forced (``fsdp.serve_layout(force_seq=True)``).
A random whole cache (f32, or bf16) laid out with ``fsdp.shard_cache``
under ``sharding.decode_rules``; batch 4 over the data axes and batch 1
(its sequence over data and model); ``STEPS`` tokens a row at per-row
positions that cross the shards' boundaries.  Logits within 2e-4 of
JAX's unsharded ``decode_step`` at every step (each rank's rows) and
within 2e-5 of the port's own unsharded decode (5e-4 over a bf16 cache:
see ``LAYOUT_TOL``); each step's collectives
exactly ``chip_smoke._decode_collectives``, every attention call on the
column arm.
"""
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
L = 16                      # cache rows (the ring layers' window: 8)
STEPS = 3
TOL = 2e-4
# against the port's own unsharded decode: 2e-5 in f32.  A bf16 cache
# rounds each step's new K/V row to bf16, and a rank's columns of a
# product may sit an f32 ulp off the whole product's, so a row element
# may round the other way (a bf16 ulp, 2**-8 of it): 6e-5 to 3.6e-4 on
# these logits after two steps, so bf16 is held to 5e-4 there, as
# test_torch_decode_layout.py holds int8 codes that round the other way
LAYOUT_TOL = {"f32": 2e-5, "bf16": 5e-4}
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
POS0 = {4: [2, 5, 8, 11], 1: [9]}
ARCHS = ("minicpm", "scout", "stablelm")
FORCED = ("stablelm",)
KVS = ("f32", "bf16")
CASES = [(a, b, kv) for a in ARCHS for b in (4, 1) for kv in KVS]


def _configs(pkg):
    return {"minicpm": dataclasses.replace(
                pkg.get_config("minicpm-2b").reduced(), n_heads=3,
                n_kv_heads=3),
            "scout": dataclasses.replace(
                pkg.get_config("llama4-scout-17b-a16e").reduced(),
                n_heads=5, n_kv_heads=1, sliding_window=8),
            "stablelm": pkg.get_config("stablelm-1.6b").reduced()}


def _dtype(kv):
    return torch.bfloat16 if kv == "bf16" else torch.float32


def _random_cache(ct, b, kv):
    """A whole port cache drawn from a seeded normal, as numpy f32 {path:
    array} (values a bf16 cache holds exactly)."""
    from repro_torch.models import model as TM
    cache = TM.init_cache(ct, b, L, dtype=_dtype(kv), device="cpu")
    rng = np.random.default_rng(b * 7 + len(kv))
    out = {}
    for path, t in TM.flatten(cache).items():
        if torch.is_tensor(t):
            a = torch.from_numpy(
                (0.5 * rng.standard_normal(t.shape)).astype(np.float32))
            out[path] = a.to(t.dtype).float().numpy()
    return out


def _inputs(cfg, b):
    rng = np.random.default_rng(100 + b)
    return {"tokens": rng.integers(0, cfg.vocab_size, (STEPS, b, 1))
            .astype(np.int32),
            "pos0": np.asarray(POS0[b], np.int32)}


def _port_cache(ct, b, kv, flat):
    from repro_torch.models import model as TM
    cache = TM.init_cache(ct, b, L, dtype=_dtype(kv), device="cpu")
    for path, t in TM.flatten(cache).items():
        if path in flat:
            t.copy_(torch.from_numpy(flat[path]))
    return cache


def _rows(rule, mesh, b):
    from repro_torch.distributed import sharding
    axes = tuple(rule["dp_axes"])
    n = sharding.axes_size(mesh, axes)
    r = sharding.axes_rank(mesh, axes) if axes else 0
    return slice(r * (b // n), (r + 1) * (b // n))


def _layout(ct, mesh, arch):
    from repro_torch.distributed import fsdp
    lay = fsdp.serve_layout(ct, mesh, force_seq=arch in FORCED)
    assert lay.tp and lay.seq
    return lay


def _run_case(mesh, ct, arch, params, flat, inp, b, kv):
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as TM
    lay = _layout(ct, mesh, arch)
    shards = fsdp.shard(lay, TM.cast_params(ct, params))
    rules = sharding.decode_rules(ct, mesh, batch_size=b)
    rows = _rows(rules["decode_cp"], mesh, b)
    out = {"logits": [], "counts": [], "plain": []}
    whole = TM.cast_params(ct, params)
    plain_cache = _port_cache(ct, b, kv, flat)
    # the whole cache, made outside the rules, then this rank's part
    cache = fsdp.shard_cache(ct, mesh, _port_cache(ct, b, kv, flat),
                             batch_size=b)
    with ctx.use_mesh(mesh), ctx.sharding_rules(rules):
        pos = torch.from_numpy(inp["pos0"][rows])
        for i in range(STEPS):
            batch = {"tokens": torch.from_numpy(inp["tokens"][i][rows])
                     .long()}
            collectives.reset_counts()
            dispatch.reset_launch_counts()
            o, _ = TM.decode_step(ct, shards, cache, batch, pos, layout=lay)
            out["counts"].append((collectives.counts(),
                                  dispatch.route_counts()))
            out["logits"].append(o["logits"][:, -1].float().numpy())
            with ctx.sharding_rules(None):
                o, _ = TM.decode_step(ct, whole, plain_cache, {
                    "tokens": torch.from_numpy(inp["tokens"][i]).long()},
                    torch.from_numpy(inp["pos0"] + i))
            out["plain"].append(o["logits"][rows, -1].float().numpy())
            pos = pos + 1
    out["rows"] = (rows.start, rows.stop)
    return out


def _rank_main(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch import bridge
    from repro_torch import configs as torch_configs
    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        cfgs = _configs(torch_configs)
        params = {a: bridge.params_from_jax(cfgs[a], inputs["params"][a],
                                            "cpu") for a in ARCHS}
        out = {}
        for shape in MESHES[world]:
            mesh = mesh_mod.make_mesh(shape, "cpu")
            for arch, b, kv in CASES:
                out[(shape, arch, b, kv)] = _run_case(
                    mesh, cfgs[arch], arch, params[arch],
                    inputs["caches"][(arch, b, kv)],
                    inputs["steps"][(arch, b)], b, kv)
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
    """JAX's parameters, the random caches and the token streams, written
    for the ranks; both worlds started (not joined)."""
    import jax
    from repro import configs as jax_configs
    from repro.models import model as JM
    from repro_torch import configs as torch_configs
    tmp = tmp_path_factory.mktemp("declaycols")
    cj = _configs(jax_configs)
    ct = _configs(torch_configs)
    inputs = {"params": {a: jax.tree.map(np.asarray, JM.init_params(
        cj[a], jax.random.key(0))) for a in ARCHS},
        "caches": {(a, b, kv): _random_cache(ct[a], b, kv)
                   for a, b, kv in CASES},
        "steps": {(a, b): _inputs(ct[a], b) for a in ARCHS for b in (4, 1)}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = {w: mp.spawn(_rank_main, args=(w, _free_port(), str(tmp)),
                         nprocs=w, join=False) for w in MESHES}
    return procs, tmp, cj, inputs


def _jax_cache(cj, b, kv, flat):
    """The JAX package's cache holding the port cache ``flat``'s values
    (scan-stacked layers: layer i at [i // cycle] of entry i % cycle)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.distributed.sharding import scan_stacked
    cache = JM.init_cache(cj, b, L, dtype=jnp.bfloat16 if kv == "bf16"
                          else jnp.float32)
    cyc = len(cj.block_cycle)
    stacked = scan_stacked(cj)

    def fill(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = keys[-1]
        if name == "index":
            return leaf
        if keys[0] == "layers" and stacked:
            j = keys[1]
            a = np.stack([flat[f"layers.{c * cyc + j}.{name}"]
                          for c in range(leaf.shape[0])])
        else:
            a = flat[".".join(str(k) for k in keys)]
        assert a.shape == leaf.shape, (keys, a.shape, leaf.shape)
        return jnp.asarray(a, leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, cache)


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's unsharded decode logits at every step of every case."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    _, _, cj, inputs = setup
    out = {}
    for arch, b, kv in CASES:
        cfg = cj[arch]
        params = jax.tree.map(jnp.asarray, inputs["params"][arch])
        step = jax.jit(lambda c, t, p, cfg=cfg, params=params:
                       JM.decode_step(cfg, params, c, {"tokens": t}, p))
        cache = _jax_cache(cfg, b, kv, inputs["caches"][(arch, b, kv)])
        inp = inputs["steps"][(arch, b)]
        pos = inp["pos0"]
        logits = []
        for i in range(STEPS):
            o, cache = step(cache, jnp.asarray(inp["tokens"][i]),
                            jnp.asarray(pos))
            logits.append(np.asarray(o["logits"][:, -1], np.float64))
            pos = pos + 1
        out[(arch, b, kv)] = logits
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


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


PARAMS = [(w, s, a, b, kv) for w in MESHES for s in MESHES[w]
          for a, b, kv in CASES]


@pytest.mark.parametrize("world,shape,arch,b,kv", PARAMS, ids=[
    f"{'x'.join(map(str, s))}-{a}-b{b}-{kv}" for w, s, a, b, kv in PARAMS])
def test_column_arm_matches_unsharded_jax(ranks, jax_refs, world, shape,
                                          arch, b, kv):
    from repro_torch import configs as torch_configs
    want = jax_refs[(arch, b, kv)]
    res = [r[(shape, arch, b, kv)] for r in ranks[world]]
    for got in res:
        lo, hi = got["rows"]
        for i in range(STEPS):
            err = float(np.abs(got["logits"][i] - want[i][lo:hi]).max())
            assert err <= TOL, (i, err)
            err = float(np.abs(got["logits"][i] - got["plain"][i]).max())
            assert err <= LAYOUT_TOL[kv], (i, err)
    ct = _configs(torch_configs)[arch]
    mesh = dict(zip(("data", "model"), shape))
    cs = _chip_smoke()
    want_c = cs._decode_collectives(ct, _layout(ct, mesh, arch))
    for got in res:
        for coll, routes in got["counts"]:
            assert coll == want_c, (coll, want_c)
            assert routes["tp_decode_cols"] == \
                cs._decode_attention_layers(ct)
            assert routes["tp_decode_heads"] == 0
