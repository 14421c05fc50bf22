"""Slice 6b-i's plan: the port's tensor- and sequence-parallel rules
against the JAX package's.

For all ten configs on the meshes (data 1, model 2), (2, 2), (1, 4) and
(pod 2, data 1, model 2), with a batch the data axes divide and one they
do not: ``activation_rules``' layout entries ("residual", "attn_q",
"attn_kv", the sequence-sharded switch included) as the reference's
PartitionSpecs, entry by entry; the head-locality check
``attention_shard_spec`` and the row check ``rmsnorm_shard_spec`` (with
the rules installed and without), spec or refusal, as the reference's
(the port keeps these two for parity only).  The JAX side runs in a subprocess on eight
fake host devices; the port plans from the axis sizes alone.

Then the port's own decision, leaf by leaf, read from the rules' head
entries: ``sharding.tp_holds`` keeps a plan's "model" entry where the
split falls on whole q heads, whole kv heads (else the kv leaves are held
whole), whole d_ff columns and whole vocab rows, and on the experts; ``fsdp.layout`` holds exactly those, so a
rank holds 1/tp of ``wq``, ``wo``, ``gate``, ``up``, ``down`` and of the
divisible vocab leaves.  Every config is covered (slice 6b-ii added
mamba2 with zamba2's shared block, mLSTM, sLSTM and Whisper): mamba2's
``in_proj`` and conv leaves are split part by part and the sLSTM's ``r``
over its heads (``sharding.tp_splits``), and a layout the port refuses is
a ValueError naming its reason or its ROADMAP item.
"""
import json
import os
import re
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
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x1x2": (2, 1, 2)}
BATCHES = (4, 3)
ROWS = (4096, 24, 6)
RULES = ("residual", "attn_q", "attn_kv")

_JAX_RULES = r"""
import json, math, sys
import jax
from repro.configs import get_config, ARCH_IDS
from repro.distributed import sharding

def canon(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e

meshes = json.loads(sys.argv[1])
batches = json.loads(sys.argv[2])
rows = json.loads(sys.argv[3])
out = {}
for mname, shape in meshes.items():
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(tuple(shape), axes,
                         devices=jax.devices()[:math.prod(shape)])
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for b in batches:
            rules = sharding.activation_rules(mesh, batch_size=b, cfg=cfg)
            out[f"rules|{arch}|{mname}|{b}"] = {
                k: [canon(e) for e in tuple(rules[k].spec)]
                for k in ("residual", "attn_q", "attn_kv")}
            spec, why = sharding.attention_shard_spec(
                mesh, batch=b, n_q_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads)
            out[f"attn|{arch}|{mname}|{b}"] = [
                None if spec is None else [canon(spec.batch), spec.heads],
                why]
    rules = sharding.activation_rules(mesh, batch_size=batches[0])
    for r in rows:
        for with_rules in (True, False):
            spec, why = sharding.rmsnorm_shard_spec(
                mesh, rows=r, rules=rules if with_rules else None)
            out[f"rows|{mname}|{r}|{with_rules}"] = [
                None if spec is None else list(spec.axes), why]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_rules():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_RULES, json.dumps(MESHES),
         json.dumps(BATCHES), json.dumps(ROWS)], env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(name):
    shape = MESHES[name]
    return dict(zip(mesh_mod.axis_names(len(shape)), shape))


def _canon(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e


@pytest.mark.parametrize("arch", torch_configs.ARCH_IDS)
def test_activation_rules_and_head_check_match_jax(jax_rules, arch):
    cfg = torch_configs.get_config(arch)
    for mname in MESHES:
        for b in BATCHES:
            rules = sharding.activation_rules(_mesh(mname), batch_size=b,
                                              cfg=cfg)
            got = {k: [_canon(e) for e in rules[k]] for k in RULES}
            assert got == jax_rules[f"rules|{arch}|{mname}|{b}"], \
                (arch, mname, b)
            spec, why = sharding.attention_shard_spec(
                _mesh(mname), batch=b, n_q_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads)
            got = [None if spec is None else [_canon(spec.batch),
                                              spec.heads], why]
            assert got == jax_rules[f"attn|{arch}|{mname}|{b}"], \
                (arch, mname, b)


@pytest.mark.parametrize("mname", list(MESHES))
def test_row_check_matches_jax(jax_rules, mname):
    rules = sharding.activation_rules(_mesh(mname), batch_size=BATCHES[0])
    for rows in ROWS:
        for with_rules in (True, False):
            spec, why = sharding.rmsnorm_shard_spec(
                _mesh(mname), rows=rows, rules=rules if with_rules else None)
            want_spec, want_why = jax_rules[f"rows|{mname}|{rows}|"
                                            f"{with_rules}"]
            assert (None if spec is None else list(spec.axes)) == want_spec
            # the port words the sequence-parallel refusal its own way
            assert bool(why) == bool(want_why), (mname, rows, with_rules)
            if with_rules and _mesh(mname)["model"] > 1:
                assert "sequence-parallel residual" in why


def _expected_hold(arch, cfg, path, tp):
    """The rule, written out: experts always; the kv leaves where the kv
    heads divide tp; every other planned "model" entry (q heads, d_ff,
    vocab and the recurrent widths divide for these meshes)."""
    if ".moe.w_" in path:
        return True
    if ".attn.wk." in path or ".attn.wv." in path:
        return cfg.n_kv_heads % tp == 0
    return True


def _expected_held(cfg, path, spec):
    """The held spec of a leaf the port holds over "model": the plan's,
    but the sLSTM's ``r`` over its heads (dim 0) instead of its gates."""
    if path.endswith(".slstm.r"):
        return ("model", spec[1], None)
    return spec


@pytest.mark.parametrize("arch", torch_configs.ARCH_IDS)
def test_held_model_entries_leaf_by_leaf(arch):
    cfg = torch_configs.get_config(arch)
    shapes = TM.param_shapes(cfg)
    for mname in MESHES:
        mesh = _mesh(mname)
        tp = mesh["model"]
        plan = sharding.param_shardings(cfg, mesh, shapes)
        holds = sharding.tp_holds(cfg, mesh, shapes)
        lay = fsdp.layout(cfg, mesh)
        covered = not sharding.tp_refusal(cfg, mesh)
        assert lay.tp == covered, (arch, mname)
        assert set(holds) == {p for p, s in plan.items()
                              if "model" in str(s)}
        for path, spec in plan.items():
            if path in holds:
                assert holds[path] == _expected_hold(arch, cfg, path, tp), \
                    (arch, mname, path)
            want = _expected_held(cfg, path, spec) if holds.get(path) else \
                sharding.strip_axis(spec, "model")
            assert lay.held[path] == want, (arch, mname, path)
        assert covered, (arch, mname)
        # a rank's share of the split leaves
        for path, shape in shapes.items():
            name = path.split(".", 2)[-1] if path.startswith("layers.") \
                else path
            if name in ("attn.wq.w", "mlp.gate.w", "mlp.up.w"):
                assert lay.held[path][1] == "model", (arch, path)
            if name in ("attn.wo.w", "mlp.down.w"):
                assert lay.held[path][0] == "model", (arch, path)
            # the blocked splits: mamba2's z | x | B | C | dt columns and
            # x | B | C conv channels, each part split on its own
            if name.endswith("mamba.in_proj.w"):
                d_in = cfg.ssm_heads * cfg.ssm_head_dim
                gn = cfg.ssm_groups * cfg.ssm_state
                assert lay.block(path) == (1, (d_in, d_in, gn, gn,
                                               cfg.ssm_heads)), path
            elif ".mamba.conv_" in path:
                assert lay.block(path)[1] == (
                    cfg.ssm_heads * cfg.ssm_head_dim,
                    cfg.ssm_groups * cfg.ssm_state,
                    cfg.ssm_groups * cfg.ssm_state), path
            else:
                assert lay.block(path) is None, path
        vocab_split = cfg.vocab_size % tp == 0
        assert lay.sharded("embed.table", "model") == vocab_split
        if not cfg.tie_embeddings:
            assert lay.sharded("lm_head.w", "model") == vocab_split


def test_shards_hold_one_tp_th_of_the_split_leaves():
    """On a (1, 2) mesh of one process's view (rank 0), the shards of
    reduced yi-6b: 1/2 of wq's columns, wo's rows, the MLP's d_ff and the
    vocab rows; wk and wv (one kv head) whole."""
    cfg = torch_configs.get_config("yi-6b").reduced()
    shapes = TM.param_shapes(cfg)
    holds = sharding.tp_holds(cfg, _mesh("1x2"), shapes)
    assert holds["layers.0.attn.wq.w"] and holds["embed.table"]
    assert not holds["layers.0.attn.wk.w"]
    assert not holds["layers.1.attn.wv.w"]
    assert holds["layers.1.mlp.down.w"] and holds["lm_head.w"]


@pytest.mark.parametrize("arch,shape,force,words", [
    # 4 xLSTM heads over 6 ranks: they do not divide the axis, nor is the
    # axis a multiple of them (the head-split arm's case)
    ("xlstm-1.3b", (1, 6), False, "mLSTM/sLSTM heads 4 does not divide "
                                  "the 6-way model axis, nor is the axis")])
def test_unsupported_tp_layout_raises_naming_its_roadmap_item(arch, shape,
                                                               force, words):
    cfg = torch_configs.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    with pytest.raises(ValueError, match=words):
        fsdp.layout(cfg, mesh, force_seq=force)


@pytest.mark.parametrize("arch,shape,force", [
    # the head-split arm: xLSTM's 4 heads over 8 ranks, g = 2
    ("xlstm-1.3b", (1, 8), False),
    # the encoder's frames padded over the axis, heads local at 8
    ("whisper-base", (1, 8), False),
    # its 8 q heads pinned to the sequence at 16: the sequence arm
    ("whisper-base", (1, 16), False),
    # the encoder-decoder's sequence arm forced over one rank
    ("whisper-base", (1, 1), True)])
def test_wider_model_axes_hold_the_slice_6b_iv_arms(arch, shape, force):
    """The layouts slice 6b-iv added where the port refused before: every
    planned "model" entry held (the plan's split; the sLSTM's ``r`` a
    head a group of g ranks), the attention on the sequence arm where the
    q heads do not divide the axis (wk, wv whole where the kv heads do
    not), and nothing refused."""
    cfg = torch_configs.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    lay = fsdp.layout(cfg, mesh, force_seq=force)
    tp = shape[1]
    assert lay.tp and not sharding.tp_refusal(cfg, mesh)
    assert lay.seq == (force or (cfg.is_encdec and cfg.n_heads % tp != 0))
    g = sharding.head_split(cfg, mesh)
    assert lay.head_split == g == (tp // 4 if arch == "xlstm-1.3b" else 0)
    plan = sharding.param_shardings(cfg, mesh)
    splits = sharding.tp_splits(cfg, mesh)
    for path, spec in plan.items():
        if "model" not in str(spec):
            continue
        kv = re.search(r"attn\.(wk|wv)\.", path)
        if kv and cfg.n_kv_heads % tp:
            assert path not in splits and not lay.sharded(path, "model")
        elif path.endswith("slstm.r"):
            assert splits[path].kind == "grouped" and splits[path].g == g
            assert lay.held[path] == (sharding.Grouped("model", g),
                                      spec[1], None), path
        else:
            assert lay.held[path] == spec, path


@pytest.mark.parametrize("arch,shape", [
    ("minicpm-2b", (1, 8)), ("llama4-scout-17b-a16e", (1, 16)),
    # zamba2's shared attention block: its 32 q heads over 64 ranks
    ("zamba2-1.2b", (1, 64))])
def test_seq_arm_holds_the_plans_split(arch, shape):
    """Where the q heads do not divide the model axis the layout takes the
    sequence arm: wq's columns and wo's rows held as the plan splits them,
    off head boundaries, and wk, wv (whose heads do not divide either)
    whole."""
    cfg = torch_configs.get_config(arch)
    mesh = dict(zip(("data", "model"), shape))
    lay = fsdp.layout(cfg, mesh)
    assert lay.tp and lay.seq
    assert sharding.seq_attention(cfg, mesh)
    plan = sharding.param_shardings(cfg, mesh)
    pre = "shared_attn.attn." if cfg.shared_attn_every else "layers.0.attn."
    for name in ("wq.w", "wo.w"):
        assert lay.held[pre + name] == plan[pre + name], name
    cols = lay.shapes[pre + "wq.w"][1] // shape[1]
    assert cols % cfg.hd != 0          # a rank's columns split a head
    for name in ("wk.w", "wv.w"):
        assert cfg.n_kv_heads % shape[1] != 0
        assert not lay.sharded(pre + name, "model"), name


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b",
                                  "whisper-base"])
def test_later_slices_keep_the_whole_dense_leaves(arch):
    """The configs whose tensor parallelism was a later slice (6b-ii) take
    it now on a model axis of 2, unasked: every planned "model" entry is
    held (the sLSTM's ``r`` moved to its heads), and the only dense leaves
    held whole on each model rank are those the plan leaves whole."""
    cfg = torch_configs.get_config(arch)
    mesh = _mesh("2x2")
    lay = fsdp.layout(cfg, mesh)
    plan = sharding.param_shardings(cfg, mesh)
    assert lay.tp
    for path, spec in plan.items():
        if "model" in str(spec):
            assert lay.held[path] == _expected_held(cfg, path, spec), path
        else:
            assert "model" not in str(lay.held[path]), path
    assert any("model" in str(s) for s in lay.held.values())
