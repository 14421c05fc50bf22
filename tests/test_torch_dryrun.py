"""The planner (``launch/dryrun.py``) and its models against the JAX
package's.

* ``traffic.hbm_bytes`` is the reference's formula on the port's cache
  bytes, and ``hlo_analysis.roofline_terms`` its arithmetic, for every
  config at every input shape on 1, 4, 256 and 512 chips: train steps
  equal exactly; prefill and decode differ by exactly the cache's stated
  differences (the reference's int32 ``index`` leaves, mamba2's conv state
  in f32 here) over the chips;
* a rank's weight bytes under the plan: wherever the port holds the
  reference's spec of a leaf (``param_shardings``, FSDP or the serving
  ``fsdp=False``), the reference's shard shape; elsewhere the port's own
  layout (a "model" entry held whole, or moved to the heads);
* a rank's cache bytes: the reference's shard bytes of every leaf but the
  recurrent states (held over their heads, the same bytes wherever both
  dims divide) and the stated differences above;
* ``--all`` on (16, 16) and on (2, 16, 16) plans every case ``ok`` but
  the one ``skipped`` (Whisper at ``long_500k``), with the record's keys
  (none is refused since slice 6b-iv); ``--mode delayed`` plans the pod
  groups; nothing is written without ``--out``.
"""
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.distributed import fsdp, sharding  # noqa: E402
from repro_torch.launch import (dryrun, hlo_analysis, specs,  # noqa: E402
                                traffic)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

ARCHS = list(torch_configs.ALIASES)
CHIPS = (1, 4, 256, 512)
PROD = {"16x16": mesh_mod.production_mesh(),
        "2x16x16": mesh_mod.production_mesh(multi_pod=True)}


def _cfgs(arch, shape):
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    return (specs.maybe_long_variant(torch_configs.get_config(arch), shape),
            jax_specs.maybe_long_variant(jax_configs.get_config(arch), shape))


def _cache_gap(ct, cj, b, s):
    """The reference's cache bytes less the port's: its int32 ``index``
    leaves, and mamba2's conv state in bf16 where the port's is f32."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    cache = jax.eval_shape(lambda: JM.init_cache(cj, b, s,
                                                 dtype=jnp.bfloat16))
    gap = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        if str(getattr(path[-1], "key", "")) == "index":
            gap += leaf.size * leaf.dtype.itemsize
    n_mamba = sum(k == "mamba2" for k in ct.layer_kinds())
    conv_ch = ct.ssm_heads * ct.ssm_head_dim + 2 * ct.ssm_groups * \
        ct.ssm_state
    return gap - n_mamba * b * (ct.ssm_conv_width - 1) * conv_ch * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_bytes_and_roofline_match_the_reference(arch):
    from repro.launch import hlo_analysis as jax_hlo
    from repro.launch import mesh as jax_mesh
    from repro.launch import traffic as jax_traffic
    for shape, sh in specs.INPUT_SHAPES.items():
        ct, cj = _cfgs(arch, shape)
        kind = sh["kind"]
        gap = 0 if kind == "train" else \
            _cache_gap(ct, cj, sh["batch"], sh["seq"])
        want1 = jax_traffic.hbm_bytes(cj, shape, kind, 1)
        for n in CHIPS:
            got = traffic.hbm_bytes(ct, shape, kind, n)
            # the reference divides its one total by the chips
            assert got == pytest.approx((want1 - gap) / n, rel=1e-12), \
                (shape, n)
            kw = dict(hlo_flops=6.0e18 / n, hbm_bytes=got,
                      collective_total=1.5e9, n_chips=n)
            for rates in ((jax_mesh.PEAK_FLOPS_BF16, jax_mesh.HBM_BW,
                           jax_mesh.ICI_BW),
                          (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW,
                           mesh_mod.NVLINK_BW)):
                rk = dict(zip(("peak_flops", "hbm_bw", "ici_bw"), rates))
                assert hlo_analysis.roofline_terms(**kw, **rk) == \
                    jax_hlo.roofline_terms(**kw, **rk)


def _ref_param_specs(cj, jmesh, *, serving, fsdp_on):
    import jax
    from repro.distributed import sharding as JS
    from repro.launch import specs as jax_specs
    from repro.models import model as JM
    p = jax_specs.params_specs(cj)
    if serving:
        p = jax.eval_shape(lambda t: JM.cast_params(cj, t), p)
    tree = JS.param_shardings(cj, jmesh, p, fsdp=fsdp_on)
    flat = {}
    leaves = dict((JS._path_str(k), v) for k, v in
                  jax.tree_util.tree_flatten_with_path(p)[0])
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        ps = JS._path_str(path)
        flat[ps] = (tuple(leaves[ps].shape), tuple(sh.spec),
                    leaves[ps].dtype.itemsize)
    return flat


def _shard_elems(shape, spec, sizes):
    n = math.prod(shape)
    for ax in spec:
        n //= sharding.entry_parts(sizes, ax)
    return n


def _port_to_ref(ct, path):
    parts = path.split(".")
    if parts[0] == "layers" and sharding.scan_stacked(ct):
        return "/".join(["layers", str(int(parts[1]) %
                                       len(ct.block_cycle))] + parts[2:]), 1
    return "/".join(parts), 0


@pytest.mark.parametrize("mesh_name", list(PROD))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_match_the_reference_plan(arch, mesh_name):
    from repro.compat import abstract_mesh
    sizes = PROD[mesh_name]
    jmesh = abstract_mesh(tuple(sizes.values()), tuple(sizes))
    for shape, sh in specs.INPUT_SHAPES.items():
        ct, cj = _cfgs(arch, shape)
        rec = dryrun.plan_case(arch, shape, multi_pod=mesh_name != "16x16")
        if rec["status"] != "ok":
            assert rec["status"] in ("skipped", "refused") and rec["reason"]
            continue
        serving = sh["kind"] == "decode"
        lay = fsdp.serve_layout(ct, sizes) if serving else \
            fsdp.layout(ct, sizes)
        ref = _ref_param_specs(cj, jmesh, serving=serving,
                               fsdp_on=not serving)
        holds = sharding.tp_holds(ct, sizes)
        total = 0
        for path, shp in lay.shapes.items():
            rpath, lead = _port_to_ref(ct, path)
            rshape, rspec, item = ref[rpath]
            rspec = tuple(rspec[lead:]) + (None,) * len(shp)
            rspec = rspec[:len(shp)]
            assert tuple(rshape[lead:]) == tuple(shp), path
            held = lay.held[path]
            if held == tuple(rspec):
                n = _shard_elems(shp, rspec, sizes)
            else:
                # a stated difference: the entry held whole over "model"
                # (tp_holds), or moved to the heads (the sLSTM's r; under
                # the head-split arm a head a group of g ranks: g times
                # the reference's bytes)
                assert sharding.strip_axis(held, "model") == \
                    sharding.strip_axis(tuple(rspec), "model"), path
                assert not holds.get(path) or path.endswith("slstm.r"), path
                n = _shard_elems(shp, held, sizes)
                if path.endswith("slstm.r"):
                    g = sharding.head_split(ct, sizes) or 1
                    assert n == g * _shard_elems(shp, rspec, sizes)
            total += n * (item if len(shp) >= 2 else 4)
        assert rec["memory"]["params"] == total, (shape, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_cache_bytes_match_the_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.compat import abstract_mesh
    from repro.distributed import sharding as JS
    from repro.models import model as JM
    sizes = PROD["16x16"]
    jmesh = abstract_mesh((16, 16), ("data", "model"))
    for shape in ("decode_32k", "long_500k"):
        rec = dryrun.plan_case(arch, shape)
        if rec["status"] != "ok":
            continue
        ct, cj = _cfgs(arch, shape)
        g = sharding.head_split(ct, sizes)
        b, s = (specs.INPUT_SHAPES[shape][k] for k in ("batch", "seq"))
        cache = jax.eval_shape(lambda: JM.init_cache(cj, b, s,
                                                     dtype=jnp.bfloat16))
        tree = JS.cache_shardings(cj, jmesh, cache, batch_size=b)
        want = 0
        for (path, leaf), (_, sh) in zip(
                jax.tree_util.tree_flatten_with_path(cache)[0],
                jax.tree_util.tree_flatten_with_path(tree)[0]):
            name = JS._path_str(path).rsplit("/", 1)[-1]
            if name == "index":
                continue
            item = leaf.dtype.itemsize
            if name == "conv" and "mamba2" in ct.layer_kinds():
                item = 4
            n = _shard_elems(leaf.shape, tuple(sh.spec), sizes)
            if g and name != "conv":
                # the head-split arm: the mLSTM's C on the rank's v rows
                # (the reference's bytes), its m (B, H) one head of the
                # H the reference holds whole, its n and the sLSTM's
                # states the head whole on its g ranks (g times the
                # reference's bytes, which split their last dim)
                n = n // ct.n_heads if name == "m" and \
                    leaf.shape[-1] == ct.n_heads else n * (name != "C" and
                                                           g or 1)
            want += n * item
        assert rec["memory"]["cache"] == want, shape


RECORD_KEYS = {"arch", "variant", "shape", "kind", "mesh", "mode", "status",
               "params", "active_params", "model_flops",
               "hbm_bytes_per_chip", "roofline", "memory",
               "collective_bytes"}


@pytest.mark.parametrize("argv", [["--all"], ["--all", "--multi-pod"]])
def test_all_cases_plan_ok_skipped_or_refused(argv, capsys):
    """Every case plans: 39 ok and Whisper's long_500k skipped, none
    refused (xlstm-1.3b's heads split over groups of 4 ranks, Whisper's
    frames padded over the 16-way model axis)."""
    assert dryrun.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(x) for x in lines]
    assert len(recs) == len(ARCHS) * len(specs.INPUT_SHAPES)
    by = {}
    for r in recs:
        by.setdefault(r["status"], []).append((r["arch"], r["shape"]))
        if r["status"] == "ok":
            assert RECORD_KEYS <= set(r), r["arch"]
            assert r["collective_bytes"] is None
            assert r["roofline"]["t_collective"] is None
            assert r["memory"]["card"].startswith("NVIDIA H100 80GB HBM3")
            assert r["memory"]["fits"] == \
                (r["memory"]["total"] <= 80 * 10 ** 9)
        else:
            assert r["reason"], r
    assert set(by) <= {"ok", "skipped", "refused"}
    assert by["skipped"] == [("whisper-base", "long_500k")]
    assert "refused" not in by
    assert (len(by["ok"]), len(by["skipped"])) == (39, 1)
    # the cases refused before this slice plan, each with a memory record
    for r in recs:
        if r["arch"] in ("xlstm-1.3b", "whisper-base") and \
                r["status"] == "ok":
            assert r["memory"]["fits"] is True, (r["arch"], r["shape"])
    decode = [r for r in recs if r["status"] == "ok" and
              r["kind"] == "decode"]
    assert all(r["roofline"]["dominant"] == "memory" for r in decode)


def test_delayed_mode_and_out(tmp_path, capsys):
    out = tmp_path / "plan.jsonl"
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "--multi-pod", "--mode", "delayed",
                        "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "ok" and rec["mode"] == "delayed"
    sync = dryrun.plan_case("yi-6b", "train_4k", multi_pod=True)
    # each pod holds a copy, FSDP over its own data ranks only
    ct = torch_configs.get_config("yi-6b")
    lay = fsdp.layout(ct, PROD["2x16x16"], pod_groups=True)
    assert rec["memory"]["params"] == \
        dryrun.param_bytes(lay, serving=False, cfg=ct) > \
        sync["memory"]["params"]
    assert json.loads(out.read_text()) == rec
    with pytest.raises(ValueError, match="pod"):
        dryrun.plan_case("yi-6b", "train_4k", mode="delayed")


def test_mesh_constants_are_the_h100s():
    """The production meshes as {axis: size} and the H100's roofline
    constants, each stamped with the card (not the reference's TPU
    v5e's)."""
    from repro.launch import mesh as jax_mesh
    assert mesh_mod.production_mesh() == {"data": 16, "model": 16}
    assert mesh_mod.production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 16, "model": 16}
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    assert mesh_mod.DEVICE == "NVIDIA H100 80GB HBM3, 700 W, datasheet"
    assert mesh_mod.PEAK_FLOPS_BF16 != jax_mesh.PEAK_FLOPS_BF16
