"""Slice 6b-i's layers under tensor and sequence parallelism, over two gloo
ranks (a (data 1, model 2) view: every rank holds its half of the
sequence rows and of the heads, d_ff columns or vocab rows), against the
JAX package's whole functions on the same numpy inputs, f32, tolerance
1e-5.  Each layer is driven as ``models/model.py`` drives it: the rows
gathered along the sequence (``gather_sum``), the layer on this rank's
leaves, the partial sums reduce-scattered back to the rows
(``scatter_sum``); the loss is sum(out * c) over the global rows.

* ``attend_train`` with local heads (stablelm's 4/4 heads with partial
  rotary, granite's 4/2) and with kv heads held whole (yi's and qwen2's
  one kv head, qwen2 with its qkv bias): outputs, the rows' gradients and
  every leaf's gradient (a whole kv leaf's summed over the ranks) against
  ``repro.models.attention.attend_train``;
* ``gated_mlp`` on its d_ff columns against ``repro.models.mlp``;
* the vocab-parallel embedding (``common.embed_vocab_parallel``) against
  ``repro.models.common.embed``, rows and table gradient;
* the vocab-parallel log-probabilities and entropy of
  ``llm_a3c.logp_entropy`` against the reference loss's
  ``log_softmax`` forms, values and logit gradients.

And the kernel the local heads reach: the plain flash attention on each
rank's heads against the JAX dispatch's ``pallas_shard_map`` over a
(1, 2) mesh (interpret mode), run in a subprocess on two fake host
devices.
"""
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
WORLD = 2
B, S = 2, 16
TOL = 1e-5
ATTN_ARCHS = {"yi": "yi-6b", "qwen2": "qwen2-72b", "stablelm": "stablelm-1.6b",
              "granite": "granite-moe-1b-a400m"}
VOCAB = 512


def _cfg(pkg, arch):
    return dataclasses.replace(pkg.get_config(ATTN_ARCHS[arch]).reduced(),
                               dtype="float32")


def _attn_params(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    out = {}
    for name, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                    ("wv", cfg.n_kv_heads)):
        out[name] = {"w": rng.standard_normal((d, n * hd)) / np.sqrt(d)}
        if cfg.qkv_bias:
            out[name]["b"] = 0.1 * rng.standard_normal(n * hd)
    out["wo"] = {"w": rng.standard_normal((cfg.n_heads * hd, d))
                 / np.sqrt(cfg.n_heads * hd)}
    return _f32(out)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _inputs():
    from repro_torch import configs
    rng = np.random.default_rng(0)
    out = {"attn": {}}
    for arch in ATTN_ARCHS:
        cfg = _cfg(configs, arch)
        out["attn"][arch] = {
            "p": _attn_params(rng, cfg),
            "x": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            "c": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    d, f = 256, 512
    out["mlp"] = {"p": _f32({"gate": {"w": rng.standard_normal((d, f))
                                       / 16.0},
                             "up": {"w": rng.standard_normal((d, f)) / 16.0},
                             "down": {"w": rng.standard_normal((f, d))
                                      / np.sqrt(f)}}),
                  "x": rng.standard_normal((B, S, d)).astype(np.float32),
                  "c": rng.standard_normal((B, S, d)).astype(np.float32)}
    out["embed"] = {
        "table": rng.standard_normal((VOCAB, d)).astype(np.float32),
        "ids": rng.integers(0, VOCAB, (B, S)).astype(np.int32),
        "c": rng.standard_normal((B, S, d)).astype(np.float32)}
    out["logp"] = {
        "logits": 3.0 * rng.standard_normal((B, S, VOCAB)).astype(np.float32),
        "actions": rng.integers(0, VOCAB, (B, S)).astype(np.int32),
        "ca": rng.standard_normal((B, S)).astype(np.float32),
        "ce": rng.standard_normal((B, S)).astype(np.float32)}
    return out


def _rows(r):
    return slice(r * S // WORLD, (r + 1) * S // WORLD)


def _cols(n, r):
    return slice(r * n // WORLD, (r + 1) * n // WORLD)


def _local_attn(p, cfg, r):
    """This rank's leaves as ``fsdp.layout`` holds them: q and o by heads,
    k and v by heads where the kv heads divide the ranks, else whole."""
    hd = cfg.hd
    split_kv = cfg.n_kv_heads % WORLD == 0
    out = {}
    for name in ("wq", "wk", "wv"):
        n = (cfg.n_heads if name == "wq" else cfg.n_kv_heads) * hd
        if name != "wq" and not split_kv:
            out[name] = dict(p[name])
            continue
        out[name] = {k: v[..., _cols(n, r)] for k, v in p[name].items()}
    out["wo"] = {"w": p["wo"]["w"][_cols(cfg.n_heads * hd, r)]}
    return out


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy().copy()


def _rank_main(rank, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.core import llm_a3c
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.kernels import dispatch
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    from repro_torch.models import mlp as mlp_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        inp = _inputs()
        group = dist.group.WORLD
        tp = fsdp.TPRule(group, WORLD, rank, True)
        rows = _rows(rank)
        out = {"attn": {}}
        for arch, a in inp["attn"].items():
            cfg = _cfg(configs, arch)
            p = _t(_local_attn(a["p"], cfg, rank))
            x = _t(a["x"][:, rows])
            cos, sin = cm.rope_cos_sin(torch.arange(S)[None], cfg.hd,
                                       cfg.rope_theta)
            dispatch.reset_launch_counts()
            h = collectives.gather_sum(x, group, 1)
            y = collectives.scatter_sum(
                attn.attend_train(p, h, cos, sin, cfg, tp=tp), group, 1)
            (y * torch.from_numpy(a["c"][:, rows])).sum().backward()
            out["attn"][arch] = {"y": y.detach().numpy(),
                                 "dx": x.grad.numpy(), "dp": _grads(p),
                                 "routes": dispatch.route_counts()}
        m = inp["mlp"]
        p, x = _t(m["p"]), _t(m["x"][:, rows])
        p = {"gate": {"w": p["gate"]["w"]}, "up": {"w": p["up"]["w"]},
             "down": {"w": p["down"]["w"]}}
        local = {k: {"w": _t(m["p"][k]["w"][..., _cols(512, rank)]
                             if k != "down" else
                             m["p"][k]["w"][_cols(512, rank)])}
                 for k in ("gate", "up", "down")}
        y = collectives.scatter_sum(mlp_mod.gated_mlp(
            local, collectives.gather_sum(x, group, 1)), group, 1)
        (y * torch.from_numpy(m["c"][:, rows])).sum().backward()
        out["mlp"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                      "dp": _grads(local)}
        e = inp["embed"]
        table = _t(e["table"][_cols(VOCAB, rank)])
        y = cm.embed_vocab_parallel({"table": table},
                                    torch.from_numpy(e["ids"]),
                                    start=rank * VOCAB // WORLD,
                                    group=group, dtype=torch.float32)
        (y * torch.from_numpy(e["c"][:, rows])).sum().backward()
        out["embed"] = {"y": y.detach().numpy(),
                        "dtable": table.grad.numpy()}
        lp = inp["logp"]
        logits = _t(lp["logits"][..., _cols(VOCAB, rank)])
        la, ent = llm_a3c.logp_entropy(
            logits, torch.from_numpy(lp["actions"]),
            start=rank * VOCAB // WORLD, group=group)
        ((la * torch.from_numpy(lp["ca"])).sum()
         + (ent * torch.from_numpy(lp["ce"])).sum()).backward()
        out["logp"] = {"logp_a": la.detach().numpy(),
                       "entropy": ent.detach().numpy(),
                       "dlogits": logits.grad.numpy()}
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
    tmp = tmp_path_factory.mktemp("tpb")
    procs = mp.spawn(_rank_main, args=(_free_port(), str(tmp)),
                     nprocs=WORLD, join=False)
    return procs, tmp


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The reference's whole functions and their gradients."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jax_configs
    from repro.models import attention as jattn
    from repro.models import common as jcm
    from repro.models import mlp as jmlp
    inp = _inputs()
    out = {"attn": {}}
    for arch, a in inp["attn"].items():
        cfg = _cfg(jax_configs, arch)
        cos, sin = jcm.rope_cos_sin(jnp.arange(S)[None], cfg.hd,
                                    cfg.rope_theta)

        def f(p, x, cfg=cfg, cos=cos, sin=sin):
            return jattn.attend_train(p, x, cos, sin, cfg)
        p = jax.tree.map(jnp.asarray, a["p"])
        y, vjp = jax.vjp(f, p, jnp.asarray(a["x"]))
        dp, dx = vjp(jnp.asarray(a["c"]))
        out["attn"][arch] = {"y": np.asarray(y), "dx": np.asarray(dx),
                             "dp": jax.tree.map(np.asarray, dp)}
    m = inp["mlp"]
    y, vjp = jax.vjp(lambda p, x: jmlp.gated_mlp(p, x),
                     jax.tree.map(jnp.asarray, m["p"]), jnp.asarray(m["x"]))
    dp, dx = vjp(jnp.asarray(m["c"]))
    out["mlp"] = {"y": np.asarray(y), "dx": np.asarray(dx),
                  "dp": jax.tree.map(np.asarray, dp)}
    e = inp["embed"]
    y, vjp = jax.vjp(lambda t: jcm.embed({"table": t}, jnp.asarray(e["ids"])),
                     jnp.asarray(e["table"]))
    out["embed"] = {"y": np.asarray(y),
                    "dtable": np.asarray(vjp(jnp.asarray(e["c"]))[0])}
    lp = inp["logp"]

    def logp(logits):
        # the reference loss's forms (repro/core/llm_a3c.py)
        logp_all = jax.nn.log_softmax(logits)
        la = jnp.take_along_axis(logp_all, jnp.asarray(lp["actions"])[
            ..., None], -1)[..., 0]
        ent = -jnp.sum(jnp.exp(logp_all) * logp_all, -1)
        return la, ent
    (la, ent), vjp = jax.vjp(logp, jnp.asarray(lp["logits"]))
    out["logp"] = {"logp_a": np.asarray(la), "entropy": np.asarray(ent),
                   "dlogits": np.asarray(vjp((jnp.asarray(lp["ca"]),
                                              jnp.asarray(lp["ce"])))[0])}
    return out


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    procs, tmp = setup
    while not procs.join():
        pass
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _close(got, want, what):
    """Within TOL of the array's scale: f32 sums of O(1) terms (a weight
    gradient sums B x S products) round apart between the two frameworks
    by a few ulps of the sum, not of each element."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", list(ATTN_ARCHS))
def test_attention_block_matches_jax(ranks, jax_refs, arch):
    from repro_torch import configs
    cfg = _cfg(configs, arch)
    want = jax_refs["attn"][arch]
    kv_whole = cfg.n_kv_heads % WORLD != 0
    for r, res in enumerate(ranks):
        got = res["attn"][arch]
        _close(got["y"], want["y"][:, _rows(r)], f"{arch} out")
        _close(got["dx"], want["dx"][:, _rows(r)], f"{arch} dx")
        local = _local_attn(want["dp"], cfg, r)
        for name, leaves in local.items():
            for k, w in leaves.items():
                # a whole kv leaf's gradient is summed over the ranks
                # inside the layer, each rank's covering its own heads
                _close(got["dp"][name][k], w, f"{arch} d{name}.{k}")
        routes = got["routes"]
        assert routes["tp_heads"] == 1
        assert routes["tp_kv_whole"] == int(kv_whole)


def test_gated_mlp_matches_jax(ranks, jax_refs):
    want = jax_refs["mlp"]
    for r, res in enumerate(ranks):
        got = res["mlp"]
        _close(got["y"], want["y"][:, _rows(r)], "mlp out")
        _close(got["dx"], want["dx"][:, _rows(r)], "mlp dx")
        for k in ("gate", "up"):
            _close(got["dp"][k]["w"], want["dp"][k]["w"][:, _cols(512, r)],
                   f"d{k}")
        _close(got["dp"]["down"]["w"], want["dp"]["down"]["w"][_cols(512, r)],
               "ddown")


def test_vocab_parallel_embedding_matches_jax(ranks, jax_refs):
    want = jax_refs["embed"]
    for r, res in enumerate(ranks):
        _close(res["embed"]["y"], want["y"][:, _rows(r)], "embed rows")
        _close(res["embed"]["dtable"], want["dtable"][_cols(VOCAB, r)],
               "dtable")


def test_vocab_parallel_logp_matches_jax(ranks, jax_refs):
    want = jax_refs["logp"]
    for r, res in enumerate(ranks):
        got = res["logp"]
        _close(got["logp_a"], want["logp_a"], "log pi(a)")
        _close(got["entropy"], want["entropy"], "entropy")
        _close(got["dlogits"], want["dlogits"][..., _cols(VOCAB, r)],
               "dlogits")


_JAX_SHARD_MAP = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed import ctx
from repro.kernels import dispatch
b, s, hq, hkv, d = json.loads(sys.argv[1])
rng = np.random.default_rng(1)
q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32))
               for sh in [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, hq, d)])
mesh = jax.make_mesh((1, 2), ("data", "model"))
def loss(q, k, v):
    return jnp.sum(dispatch.flash_attention(q, k, v, causal=True) * do)
with ctx.use_mesh(mesh):
    dispatch.clear_decision_log()
    o = jax.jit(lambda q, k, v: dispatch.flash_attention(
        q, k, v, causal=True))(q, k, v)
    backend = dispatch.last_decision("flash_attention").backend
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
out = {"backend": backend,
       "arrays": [np.asarray(a).tolist() for a in (q, k, v, do, o, *grads)]}
print(json.dumps(out))
"""


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_local_heads_match_the_jax_shard_map_kernel(hq, hkv):
    """The reference's head-sharded Pallas attention (shard_map over a
    (1, 2) mesh, interpret mode) against the port's kernel on each model
    rank's heads (the plain version on the CPU), outputs and gradients."""
    from repro_torch.kernels import dispatch
    dims = [2, 128, hq, hkv, 64]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    res = subprocess.run([sys.executable, "-c", _JAX_SHARD_MAP,
                          json.dumps(dims)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["backend"] == "pallas_shard_map"
    q, k, v, do, o, dq, dk, dv = (np.asarray(a, np.float32)
                                  for a in got["arrays"])
    for r in range(WORLD):
        qh, kh = _cols(hq, r), _cols(hkv, r)
        ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
              for a in (q[:, :, qh], k[:, :, kh], v[:, :, kh])]
        out = dispatch.flash_attention(*ts, causal=True)
        (out * torch.from_numpy(np.ascontiguousarray(do[:, :, qh]))).sum() \
            .backward()
        _close(out.detach().numpy(), o[:, :, qh], "o")
        for t, want in zip(ts, (dq[:, :, qh], dk[:, :, kh], dv[:, :, kh])):
            np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-4)
