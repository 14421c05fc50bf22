"""The port's decode under the serving layout (slice 6c-i) against the JAX
package's unsharded decode, on the CPU over gloo ranks.

Two worlds run side by side: two ranks on meshes (data 1, model 2) and
(2, 1), four on (1, 4) and (2, 2).  Each case holds the JAX package's
parameters (``bridge``) as ``fsdp.serve_layout`` holds them (weights over
"model" only, taken with ``force_tp`` on a model axis of one rank), lays
a random whole cache out with ``fsdp.shard_cache`` under
``sharding.decode_rules`` and decodes ``STEPS`` tokens a row at per-row
positions that cross the shards' boundaries, each rank on its batch rows
(batch 4 over the data axes; batch 1 whole on every rank, its sequence
over data and model).  Reduced yi (kv heads held whole), its
sliding-window variant (a ring of 8 rows), stablelm, qwen2-72b (qkv
biases), granite-moe (experts E / tp), zamba2 (mamba2 and the shared
block), xlstm on the ("mlstm", "slstm") cycle and Whisper (its cross
memory split over the sequence shards); f32 and int8 KV.

Held to JAX's unsharded ``decode_step`` on the same cache: logits within
2e-4 at every step (1e-3 with int8 KV, whose codes may round the other
way: see ``TOL``), each rank's rows, and within 2e-5 of the port's own
unsharded decode of the same rows.  ``make_serve_step`` on a second
copy: greedy tokens equal to JAX's argmax wherever its top-2 margin is at
least 1e-3 (``serve.min_accept_margin``'s bound), values within 2e-4, and
the ranks' tokens equal.  Each step's collectives are exactly
``chip_smoke._decode_collectives``.
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
STEPS = 4
# logits against JAX: 2e-4 in f32.  With int8 KV an int8 code of the
# step's new K/V row rounds the other way wherever two f32 projections
# straddle a rounding boundary (torch's and XLA's, or a rank's columns and
# the whole product, an ulp apart): one code is the row's scale, ~1e-2,
# about 6e-5 to 2.4e-4 on these logits.  So int8 is held to 1e-3 against
# JAX and 5e-4 against the port's own unsharded decode, and its written
# codes to the unsharded decode's within one code, on at most 1 in 1000
# elements
TOL = {"f32": 2e-4, "int8": 1e-3}
LAYOUT_TOL = {"f32": 2e-5, "int8": 5e-4}
MARGIN = 1e-3
MESHES = {2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}
POS0 = {4: [2, 5, 8, 11], 1: [9]}
ARCHS = ("yi", "yi_sw", "stablelm", "qwen2", "granite", "zamba2", "xlstm",
         "whisper")


def _configs(pkg):
    yi = pkg.get_config("yi-6b").reduced()
    return {"yi": yi,
            "yi_sw": dataclasses.replace(yi, name="yi-6b+sw",
                                         block_cycle=("attn_local",),
                                         sliding_window=8),
            "stablelm": pkg.get_config("stablelm-1.6b").reduced(),
            "qwen2": pkg.get_config("qwen2-72b").reduced(),
            "granite": pkg.get_config("granite-moe-1b-a400m").reduced(),
            "zamba2": pkg.get_config("zamba2-1.2b").reduced(),
            "xlstm": dataclasses.replace(
                pkg.get_config("xlstm-1.3b").reduced(),
                block_cycle=("mlstm", "slstm")),
            "whisper": pkg.get_config("whisper-base").reduced()}


# int8 KV where the config has self-attention caches that take it (the
# encoder-decoder's cache takes no int8, as in the reference)
F32_ONLY = ("xlstm", "whisper")
CASES = [(a, b, kv) for a in ARCHS for b in (4, 1)
         for kv in (("f32",) if a in F32_ONLY else ("f32", "int8"))]


def _random_cache(ct, b, kv):
    """A whole port cache with every leaf drawn from a seeded normal (int8
    payloads uniform, scales positive, the sLSTM's n positive), as numpy
    {path: array}."""
    from repro_torch.models import model as TM
    dt = torch.int8 if kv == "int8" else torch.float32
    cache = TM.init_cache(ct, b, L, dtype=dt, device="cpu")
    rng = np.random.default_rng(b * 7 + len(kv))
    out = {}
    for path, t in TM.flatten(cache).items():
        if not torch.is_tensor(t):
            continue
        name = path.rsplit(".", 1)[-1]
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, t.shape).astype(np.int8)
        elif name in ("ks", "vs"):
            a = (0.01 + 0.01 * rng.random(t.shape)).astype(np.float32)
        elif name == "n":
            a = (1.0 + rng.random(t.shape)).astype(np.float32)
        else:
            a = (0.5 * rng.standard_normal(t.shape)).astype(np.float32)
        out[path] = a
    return out


def _inputs(cfg, b):
    rng = np.random.default_rng(100 + b)
    return {"tokens": rng.integers(0, cfg.vocab_size, (STEPS, b, 1))
            .astype(np.int32),
            "pos0": np.asarray(POS0[b], np.int32)}


def _port_cache(ct, b, kv, flat):
    from repro_torch.models import model as TM
    dt = torch.int8 if kv == "int8" else torch.float32
    cache = TM.init_cache(ct, b, L, dtype=dt, device="cpu")
    for path, t in TM.flatten(cache).items():
        if path in flat:
            t.copy_(torch.from_numpy(flat[path]))
    return cache


def _rows(rule, mesh, b):
    """This rank's rows of a batch of ``b``: a slice over the rule's batch
    axes, or all of them."""
    from repro_torch.distributed import sharding
    axes = tuple(rule["dp_axes"])
    n = sharding.axes_size(mesh, axes)
    r = sharding.axes_rank(mesh, axes) if axes else 0
    return slice(r * (b // n), (r + 1) * (b // n))


def _run_case(mesh, shape, ct, params, flat, inp, b):
    from repro_torch.core import llm_a3c, prng
    from repro_torch.distributed import collectives, ctx, fsdp, sharding
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as TM
    lay = fsdp.serve_layout(ct, mesh, force_tp=True)
    shards = fsdp.shard(lay, TM.cast_params(ct, params))
    rules = sharding.decode_rules(ct, mesh, batch_size=b)
    rows = _rows(rules["decode_cp"], mesh, b)
    kv = "int8" if any(v.dtype == np.int8 for v in flat.values()) else "f32"
    out = {"logits": [], "tokens": [], "values": [], "counts": [],
           "plain": []}
    step = llm_a3c.make_serve_step(ct, sample=False, layout=lay)
    whole = TM.cast_params(ct, params)
    plain_cache = _port_cache(ct, b, kv, flat)
    # whole caches, made outside the rules (under them init_cache would
    # allocate each rank's slice)
    caches = [fsdp.shard_cache(ct, mesh, _port_cache(ct, b, kv, flat),
                               batch_size=b) for _ in range(2)]
    with ctx.use_mesh(mesh), ctx.sharding_rules(rules):
        pos = torch.from_numpy(inp["pos0"][rows])
        for i in range(STEPS):
            batch = {"tokens": torch.from_numpy(inp["tokens"][i][rows])
                     .long()}
            collectives.reset_counts()
            dispatch.reset_launch_counts()
            o, _ = TM.decode_step(ct, shards, caches[0], batch, pos,
                                  layout=lay)
            out["counts"].append((collectives.counts(),
                                  dispatch.route_counts()))
            out["logits"].append(o["logits"][:, -1].numpy())
            tok, val, _ = step(shards, caches[1], batch, pos, prng.key(0))
            with ctx.sharding_rules(None):
                o, _ = TM.decode_step(ct, whole, plain_cache, {
                    "tokens": torch.from_numpy(inp["tokens"][i]).long()},
                    torch.from_numpy(inp["pos0"] + i))
            out["plain"].append(o["logits"][rows, -1].numpy())
            out["tokens"].append(tok.numpy())
            out["values"].append(val.numpy())
            pos = pos + 1
    if kv == "int8":
        out["codes"] = _code_diff(caches[0], plain_cache, rows, rules)
    out["rows"] = (rows.start, rows.stop)
    out["seq_axes"] = rules["decode_cp"]["seq_axes"]
    return out


def _code_diff(cache, whole, rows, rules):
    """(largest code difference, differing codes, codes) of this rank's
    int8 K/V against the same rows and slots of the unsharded cache."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model as TM
    big = n_diff = n_all = 0
    mine, ref = TM.flatten(cache), TM.flatten(whole)
    for path, t in mine.items():
        if not torch.is_tensor(t) or t.dtype != torch.int8:
            continue
        w = ref[path][rows]
        length = mine.get(path.rsplit(".", 1)[0] + ".global_len")
        if length is not None:
            spec = sharding.decode_cp_spec(rules["decode_cp"], length=length)
            w = w[:, spec.start:spec.start + spec.l_loc]
        d = (t.int() - w.int()).abs()
        big = max(big, int(d.max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
    return big, n_diff, n_all


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
                    mesh, shape, cfgs[arch], params[arch],
                    inputs["caches"][(arch, b, kv)],
                    inputs["steps"][(arch, b)], b)
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
    tmp = tmp_path_factory.mktemp("declay")
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
    """The JAX package's cache holding the port cache ``flat``'s values:
    scan-stacked layers take layer i at [i // cycle] of cycle entry
    i % cycle; its ``index`` leaves stay as made."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro_torch.distributed.sharding import scan_stacked
    cache = JM.init_cache(cj, b, L, dtype=jnp.float32,
                          kv_dtype=jnp.int8 if kv == "int8" else None)
    cyc = len(cj.block_cycle)
    stacked = scan_stacked(cj)

    def fill(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        name = keys[-1]
        if name == "index":
            return leaf
        if keys[0] == "layers" and stacked:
            j = keys[1]
            n = leaf.shape[0]
            a = np.stack([flat[f"layers.{c * cyc + j}.{name}"]
                          for c in range(n)])
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
        logits, values = [], []
        for i in range(STEPS):
            o, cache = step(cache, jnp.asarray(inp["tokens"][i]),
                            jnp.asarray(pos))
            logits.append(np.asarray(o["logits"][:, -1], np.float64))
            values.append(np.asarray(o["value"][:, -1], np.float64))
            pos = pos + 1
        out[(arch, b, kv)] = {"logits": logits, "values": values}
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
def test_decode_layout_matches_unsharded_jax(ranks, jax_refs, world, shape,
                                             arch, b, kv):
    """Logits within 2e-4 of JAX's unsharded decode at every step, each
    rank's rows; greedy tokens of ``make_serve_step`` equal to JAX's argmax
    where its margin is at least 1e-3, and equal on every rank holding
    the same rows; exactly ``chip_smoke._decode_collectives`` a step."""
    from repro_torch import configs as torch_configs
    from repro_torch.distributed import fsdp
    want = jax_refs[(arch, b, kv)]
    res = [r[(shape, arch, b, kv)] for r in ranks[world]]
    compared = 0
    for got in res:
        lo, hi = got["rows"]
        for i in range(STEPS):
            ref = want["logits"][i][lo:hi]
            err = float(np.abs(got["logits"][i] - ref).max())
            assert err <= TOL[kv], (i, err)
            err = float(np.abs(got["logits"][i] - got["plain"][i]).max())
            assert err <= LAYOUT_TOL[kv], (i, err)
            np.testing.assert_allclose(got["values"][i],
                                       want["values"][i][lo:hi],
                                       atol=TOL[kv])
            top2 = np.sort(ref, axis=-1)[:, -2:]
            ok = top2[:, 1] - top2[:, 0] >= MARGIN
            np.testing.assert_array_equal(got["tokens"][i][ok],
                                          ref.argmax(-1)[ok])
            compared += int(ok.sum())
        if kv == "int8":
            big, n_diff, n_all = got["codes"]
            assert big <= 1 and n_diff * 1000 <= n_all, got["codes"]
    assert compared >= len(res) * STEPS * (1 if b == 1 else 2) // 2
    by_rows = {}
    for got in res:
        by_rows.setdefault(got["rows"], []).append(
            np.stack(got["tokens"]))
    for toks in by_rows.values():
        for t in toks[1:]:
            np.testing.assert_array_equal(t, toks[0])
    ct = _configs(torch_configs)[arch]
    mesh = dict(zip(("data", "model"), shape))
    lay = fsdp.serve_layout(ct, mesh, force_tp=True)
    want_c = _chip_smoke()._decode_collectives(ct, lay)
    for got in res:
        for coll, routes in got["counts"]:
            assert coll == want_c, (coll, want_c)
            assert routes["tp_decode_heads"] == \
                _chip_smoke()._decode_attention_layers(ct)
    if b == 1 and shape[0] > 1:
        assert res[0]["seq_axes"] == ("data", "model")
