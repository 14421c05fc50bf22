"""The port's sharding plan against the JAX package's, leaf by leaf.

For every leaf of all ten configs at full shape, on the production meshes
(data 16, model 16) and (pod 2, data 16, model 16) and the small (4, 1) and
(2, 2), with FSDP on and off: ``repro_torch.distributed.sharding.
param_shardings`` (shapes from the port's ``param_shapes``) gives the
reference's ``param_shardings`` (shapes from ``specs.params_specs``, an
``eval_shape``: nothing is allocated), a scan-stacked leaf's spec taken
without its leading layer dim.  Also ``batch_shardings`` (the M-RoPE
positions included, a divided and an undivided batch) and
``activation_rules``' ``moe_ep`` entry.  The JAX side runs in a
subprocess on 512 fake host devices, the dry-run launcher's setting; the
port plans from the axis sizes alone.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.distributed import fsdp, sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16), "4x1": (4, 1),
          "2x2": (2, 2)}
BATCHES = (256, 6)

_JAX_PLANS = r"""
import json, sys
import jax
from repro.configs import get_config, ARCH_IDS
from repro.distributed import sharding
from repro.launch import specs

def entries(spec, ndim):
    out = [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]
    return out + [None] * (ndim - len(out))

meshes = json.loads(sys.argv[1])
batches = json.loads(sys.argv[2])
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    p_specs = specs.params_specs(cfg)
    for mname, shape in meshes.items():
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        mesh = jax.make_mesh(tuple(shape), axes)
        for fsdp in (True, False):
            sh = sharding.param_shardings(cfg, mesh, p_specs, fsdp=fsdp)
            flat = jax.tree_util.tree_flatten_with_path(sh)[0]
            leaves = jax.tree_util.tree_leaves(p_specs)
            out[f"{arch}|{mname}|{fsdp}"] = {
                sharding._path_str(path): entries(s.spec, leaf.ndim)
                for (path, s), leaf in zip(flat, leaves)}
        for b in batches:
            tree = {"tokens": jax.ShapeDtypeStruct((b, 8), "int32"),
                    "rewards": jax.ShapeDtypeStruct((b, 8), "float32"),
                    "positions": jax.ShapeDtypeStruct((3, b, 8), "int32")}
            bs = sharding.batch_shardings(mesh, tree, batch_size=b)
            out[f"batch|{arch}|{mname}|{b}"] = {
                k: entries(v.spec, tree[k].ndim) for k, v in bs.items()}
            rules = sharding.activation_rules(mesh, batch_size=b, cfg=cfg)
            ep = rules.get("moe_ep")
            out[f"moe_ep|{arch}|{mname}|{b}"] = None if ep is None else \
                {"tp": ep["tp"], "dp_axes": list(ep["dp_axes"])}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_plans():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_PLANS, json.dumps(MESHES),
         json.dumps(BATCHES)], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(name):
    shape = MESHES[name]
    return dict(zip(mesh_mod.axis_names(len(shape)), shape))


def _canon(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jax_key(cfg, path):
    """The reference's path of the port's leaf, and whether it is stacked
    (a leading layer dim in the reference's spec)."""
    parts = path.split(".")
    if sharding.scan_stacked(cfg) and parts[0] == "layers":
        parts[1] = str(int(parts[1]) % len(cfg.block_cycle))
        return "/".join(parts), True
    return "/".join(parts), False


@pytest.mark.parametrize("arch", torch_configs.ARCH_IDS)
def test_param_plan_matches_jax(jax_plans, arch):
    cfg = torch_configs.get_config(arch)
    shapes = TM.param_shapes(cfg)
    sharded = 0
    for mname in MESHES:
        for use_fsdp in (True, False):
            want = jax_plans[f"{arch}|{mname}|{use_fsdp}"]
            got = sharding.param_shardings(cfg, _mesh(mname), shapes,
                                           fsdp=use_fsdp)
            assert set(got) == set(shapes)
            seen = set()
            for path, spec in got.items():
                key, stacked = _jax_key(cfg, path)
                ref = want[key]
                seen.add(key)
                if stacked:
                    assert ref[0] is None, (path, ref)
                    ref = ref[1:]
                assert _canon(spec) == ref, (arch, mname, use_fsdp, path,
                                             spec, ref)
                sharded += any(e is not None for e in spec)
            assert seen == set(want), (arch, set(want) - seen)
    assert sharded > 0


def test_odd_vocab_drops_the_undivided_axis():
    """Granite-MoE's vocab (49155) does not divide over 16 model ranks, so
    its embedding is held (None, 'data'), as the reference plans it."""
    cfg = torch_configs.get_config("granite-moe-1b-a400m")
    plan = sharding.param_shardings(cfg, _mesh("16x16"))
    assert cfg.vocab_size % 16 != 0
    assert plan["embed.table"] == (None, "data")


@pytest.mark.parametrize("mname", list(MESHES))
def test_batch_plan_and_moe_rule_match_jax(jax_plans, mname):
    for arch in torch_configs.ARCH_IDS:
        cfg = torch_configs.get_config(arch)
        for b in BATCHES:
            tree = {"tokens": (b, 8), "rewards": (b, 8),
                    "positions": (3, b, 8)}
            got = sharding.batch_shardings(_mesh(mname), tree, batch_size=b)
            want = jax_plans[f"batch|{arch}|{mname}|{b}"]
            assert {k: _canon(v) for k, v in got.items()} == want
            rules = sharding.activation_rules(_mesh(mname), batch_size=b,
                                              cfg=cfg)
            ep = rules.get("moe_ep")
            got_ep = None if ep is None else {
                "tp": ep["tp"], "dp_axes": list(ep["dp_axes"])}
            assert got_ep == jax_plans[f"moe_ep|{arch}|{mname}|{b}"]


def test_held_layout_keeps_model_only_on_experts():
    """The layout of granite-moe on (2, 16, 16): "model" held on the
    experts and, under tensor parallelism, on the dense leaves whose split
    falls on whole heads (the q heads; its 8 kv heads do not divide 16, so
    wk and wv are held whole) and nowhere else (its odd vocab keeps the
    table's model entry out of the plan); the pod axis stripped for the
    delayed-sync groups, and the optimizer state on the parameters'
    plan.  Zamba2, whose tensor parallelism came with slice 6b-ii, holds
    "model" exactly where ``tp_holds`` does."""
    cfg = torch_configs.get_config("granite-moe-1b-a400m")
    mesh = _mesh("2x16x16")
    plan = sharding.param_shardings(cfg, mesh)
    lay = fsdp.layout(cfg, mesh)
    pods = fsdp.layout(cfg, mesh, pod_groups=True)
    holds = sharding.tp_holds(cfg, mesh)
    assert lay.tp and pods.tp
    assert plan["layers.0.attn.wq.w"] == (("pod", "data"), "model")
    assert lay.held["layers.0.attn.wq.w"] == (("pod", "data"), "model")
    assert pods.held["layers.0.attn.wq.w"] == ("data", "model")
    assert lay.held["layers.0.attn.wk.w"] == (("pod", "data"), None)
    assert lay.held["layers.0.moe.w_gate"] == ("model", None, None)
    assert pods.held["layers.0.moe.router"] == ("data", None)
    assert sharding.opt_state_shardings(cfg, mesh, plan) == {"g": plan}
    for path, spec in lay.held.items():
        if "model" in str(spec):
            assert ".moe.w_" in path or holds[path], (path, spec)
    later = torch_configs.get_config("zamba2-1.2b")
    lay = fsdp.layout(later, mesh)
    holds = sharding.tp_holds(later, mesh)
    assert lay.tp
    for path, spec in lay.held.items():
        if "model" in str(spec):
            assert holds[path], (path, spec)