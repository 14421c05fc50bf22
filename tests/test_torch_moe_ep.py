"""The port's expert-parallel MoE against the JAX package's ``moe_apply_ep``
on the same mesh shapes, on the CPU.

Gloo ranks (``torch.multiprocessing.spawn``): 2 on a (data 1, model 2)
mesh and 4 on (2, 2).  The JAX side runs ``moe_apply_ep`` under ``jit`` on
the same mesh shapes of fake host devices, in a subprocess.  Both take the
same inputs (numpy, from a seed): B 4, S 8, d 16, 4 experts, d_ff 8, f32.
For (top_k, capacity factor) in (1, 1.25), (2, 1.0) and (2, 4.0), each
rank's output rows and the load-balance loss, and the gradients of
J = sum(y * W) / dp + lb with respect to the router, the three expert
weights and x, agree within 1e-5.  The port's ranks hold their data
share's rows and compute one loss per data rank: the parameter gradients
are averaged over the data ranks, and x's gradient is dp times J's.  The
expert weights go in as each (the FSDP layout), run plainly and inside
``torch.utils.checkpoint`` (the model's remat region, whose backward
routes and exchanges again).  At (2, 1.0) tokens drop: the outputs differ
from the dense ``moe_apply``'s, so the comparison is not vacuous.  On one
rank the port's ``moe_apply_ep`` equals its ``moe_apply``; expert weights
held whole on more than one model rank are a ValueError.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, D, E, F = 4, 8, 16, 4, 8
CASES = [(1, 1.25), (2, 1.0), (2, 4.0)]
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODES = ("shard", "remat")
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.5,
            "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
            "w_up": rng.standard_normal((E, D, F)).astype(np.float32) / 4,
            "w_down": rng.standard_normal((E, F, D)).astype(np.float32) / 3,
            "x": rng.standard_normal((B, S, D)).astype(np.float32),
            "W": rng.standard_normal((B, S, D)).astype(np.float32)}


_JAX_EP = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.models import moe, moe_ep
src, dst = sys.argv[1], sys.argv[2]
a = dict(np.load(src))
p = {k: a[k] for k in ("router", "w_gate", "w_up", "w_down")}
out = {}
for name, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
    mesh = jax.make_mesh(shape, ("data", "model"))
    for k, cf in ((1, 1.25), (2, 1.0), (2, 4.0)):
        def f(p, x):
            y, lb = moe_ep.moe_apply_ep(p, x, top_k=k, capacity_factor=cf,
                                        act="silu", mesh=mesh,
                                        dp_axes=("data",))
            return jnp.sum(y * a["W"]) / shape[0] + lb, (y, lb)
        (_, (y, lb)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, a["x"])
        tag = f"{name}|{k}|{cf}|"
        out[tag + "y"] = np.asarray(y)
        out[tag + "lb"] = np.asarray(lb)
        out[tag + "x"] = np.asarray(gx)
        for n, g in gp.items():
            out[tag + n] = np.asarray(g)
        yd, _ = moe.moe_apply(p, a["x"], top_k=k, capacity_factor=cf,
                              act="silu")
        out[tag + "dense_y"] = np.asarray(yd)
np.savez(dst, **out)
"""


def _rank_main(rank, world, shape, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import moe_ep
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = mesh_mod.make_mesh(shape, "cpu")
        dp, tp = shape
        i = sharding.axes_rank(mesh, ("data",))
        j = sharding.axes_rank(mesh, ("model",))
        a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        rows = slice(i * B // dp, (i + 1) * B // dp)
        rule = sharding.activation_rules(mesh, batch_size=B,
                                         cfg=_MoECfg())["moe_ep"]
        e_loc = E // tp
        res = {}
        for k, cf in CASES:
            def block(p, x, k=k, cf=cf):
                return moe_ep.moe_apply_ep(p, x, top_k=k, capacity_factor=cf,
                                           act="silu", rule=rule)
            for mode in MODES:
                p = {n: a[n].clone() for n in ("router", "w_gate", "w_up",
                                               "w_down")}
                for n in ("w_gate", "w_up", "w_down"):
                    p[n] = p[n][j * e_loc:(j + 1) * e_loc].clone()
                for t in p.values():
                    t.requires_grad_(True)
                x = a["x"][rows].clone().requires_grad_(True)
                if mode == "remat":
                    y, lb = checkpoint(block, p, x, use_reentrant=False)
                else:
                    y, lb = block(p, x)
                loss = (y * a["W"][rows]).sum() + lb
                grads = torch.autograd.grad(loss, list(p.values()) + [x])
                res[(k, cf, mode)] = {
                    "y": y.detach(), "lb": lb.detach(),
                    **{n: g for n, g in zip(list(p) + ["x"], grads)}}
        try:
            moe_ep.moe_apply_ep({n: a[n] for n in ("router", "w_gate",
                                                   "w_up", "w_down")},
                                a["x"][rows], top_k=1, capacity_factor=1.0,
                                act="silu", rule=rule)
            whole = None
        except ValueError as e:
            whole = str(e)
        torch.save({"i": i, "j": j, "res": res, "whole": whole},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class _MoECfg:
    """The fields of a config that ``activation_rules`` reads."""
    n_heads = n_kv_heads = 4
    n_experts = E


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's ranks on both meshes, run side by
    side; {mesh: ([rank results], jax arrays)}."""
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_EP, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=env, stderr=subprocess.PIPE, text=True)
    ctxs = {}
    for name, shape in MESHES.items():
        d = tmp / name
        d.mkdir()
        n = shape[0] * shape[1]
        ctxs[name] = (d, n, mp.spawn(
            _rank_main, args=(n, shape, _free_port(), str(d)), nprocs=n,
            join=False))
    out = {}
    for name, (d, n, proc) in ctxs.items():
        while not proc.join():
            pass
        out[name] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    _, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "jax.npz"))
    return {name: (out[name], ref) for name in MESHES}


def _close(got, want, what):
    got = got.detach().numpy()
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", CASES, ids=[f"k{k}_cf{cf}"
                                             for k, cf in CASES])
@pytest.mark.parametrize("mode", MODES)
def test_ep_matches_jax_on_the_same_mesh(runs, mesh, case, mode):
    ranks, ref = runs[mesh]
    dp, tp = MESHES[mesh]
    k, cf = case
    tag = f"{mesh}|{k}|{cf}|"
    e_loc = E // tp
    for r in ranks:
        res = r["res"][(k, cf, mode)]
        i, j = r["i"], r["j"]
        rows = slice(i * B // dp, (i + 1) * B // dp)
        _close(res["y"], ref[tag + "y"][rows], f"y rank {i},{j}")
        _close(res["lb"], ref[tag + "lb"], "lb")
        _close(res["x"] / dp, ref[tag + "x"][rows], "x grad")
    for n in ("router", "w_gate", "w_up", "w_down"):
        for j in range(tp):
            mean = sum(r["res"][(k, cf, mode)][n] for r in ranks
                       if r["j"] == j) / dp
            want = ref[tag + n]
            if n != "router":
                want = want[j * e_loc:(j + 1) * e_loc]
            _close(mean, want, f"{n} grad, model rank {j}")


def test_whole_experts_over_model_ranks_raise(runs):
    """Each model rank takes its E / tp experts from the layout; the whole
    expert weights on a mesh of two model ranks are refused."""
    for mesh in MESHES:
        ranks, _ = runs[mesh]
        for r in ranks:
            assert "each of the 2 model ranks takes its 2" in r["whole"]


def test_dropping_case_differs_from_dense(runs):
    """The negative control: at top-2 and capacity factor 1.0 each shard
    drops tokens the dense layer keeps (and the reverse), so the EP output
    is not the dense one; at 4.0 nothing drops and they agree."""
    for mesh in MESHES:
        _, ref = runs[mesh]
        drop = f"{mesh}|2|1.0|"
        assert np.abs(ref[drop + "y"] - ref[drop + "dense_y"]).max() > 0.1
        keep = f"{mesh}|2|4.0|"
        assert np.abs(ref[keep + "y"] - ref[keep + "dense_y"]).max() < 1e-5


def test_one_rank_equals_dense_moe():
    """On a mesh of one rank every exchange is an identity and the
    capacity is the dense layer's: ``moe_apply_ep`` = ``moe_apply``, in
    the outputs, the load-balance loss and every gradient."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe, moe_ep
    a = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with sharding.process_group(torch.device("cpu")):
        mesh = mesh_mod.make_debug_mesh(device="cpu")
        rule = sharding.activation_rules(mesh, batch_size=B,
                                         cfg=_MoECfg())["moe_ep"]
        for k, cf in CASES:
            outs = []
            for fn in (lambda p, x: moe_ep.moe_apply_ep(
                    p, x, top_k=k, capacity_factor=cf, act="silu",
                    rule=rule),
                    lambda p, x: moe.moe_apply(p, x, top_k=k,
                                               capacity_factor=cf,
                                               act="silu")):
                p = {n: a[n].clone().requires_grad_(True)
                     for n in ("router", "w_gate", "w_up", "w_down")}
                x = a["x"].clone().requires_grad_(True)
                y, lb = fn(p, x)
                grads = torch.autograd.grad((y * a["W"]).sum() + lb,
                                            list(p.values()) + [x])
                outs.append([y, lb, *grads])
            for got, want in zip(*outs):
                assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
