"""Slice 6c-i's plan: the decode layout's rules against the JAX package's.

On the meshes (data 16, model 16), (pod 2, data 16, model 16), (1, 4),
(2, 2) and (4, 1) (``repro.compat.abstract_mesh`` on the JAX side; the
port plans from {axis: size}), for every config at ``decode_32k`` and
``long_500k`` (the dense configs' sliding-window variants at the latter,
as ``specs.maybe_long_variant`` picks them), with a batch of 128 and of
1, on the contiguous bf16 cache, the paged one and the int8 one:

* ``decode_rules``: the same ``seq_axes``, ``dp_axes`` and ``n_shards``;
* ``cache_shardings``: every K/V, scale, page-pool and page-table leaf
  the reference's PartitionSpec, entry by entry (a scan-stacked leaf's
  layer dim taken off);
* the recurrent states (the stated difference: the port holds them over
  their heads, the reference puts "model" on their last dim that divides
  it): the same batch entry, and wherever both put "model" on a dim, the
  same number of elements on each rank.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x4": {"data": 1, "model": 4},
          "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}}
SHAPES = ("decode_32k", "long_500k")
BATCHES = (128, 1)
VARIANTS = ("bf16", "paged", "int8")
PAGE, N_PAGES = 128, 1024
STATE_LEAVES = ("h", "conv", "C", "n", "m", "c")


def _jax_mesh(sizes):
    from repro.compat import abstract_mesh
    return abstract_mesh(tuple(sizes.values()), tuple(sizes))


def _norm(entry):
    """A spec entry in one form: a 1-tuple of axes is its axis."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


def _ref_specs(cj, mesh, cache, b):
    """The reference's cache_shardings as {"/"-path: spec tuple}."""
    import jax
    from repro.distributed import sharding as JS
    tree = JS.cache_shardings(cj, mesh, cache, batch_size=b)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[JS._path_str(path)] = tuple(_norm(e) for e in sh.spec)
    return out


def _ref_cache(cj, b, s, variant):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import model as JM
    paged = JA.PagedLayout(PAGE, N_PAGES) if variant == "paged" else None
    kv = jnp.int8 if variant == "int8" else None
    return jax.eval_shape(lambda: JM.init_cache(
        cj, b, s, dtype=jnp.bfloat16, paged=paged, kv_dtype=kv))


def _port_cache(ct, b, s, variant):
    paged = TA.PagedLayout(PAGE, N_PAGES) if variant == "paged" else None
    dt = torch.int8 if variant == "int8" else torch.bfloat16
    return TM.init_cache(ct, b, s, dtype=dt, device="meta", paged=paged)


def _ref_path(cfg, path):
    """The reference's path of the port's leaf ``path`` and whether it
    carries a leading layer dim (scan-stacked)."""
    parts = path.split(".")
    if parts[0] == "layers" and sharding.scan_stacked(cfg):
        j = int(parts[1]) % len(cfg.block_cycle)
        return "/".join(["layers", str(j)] + parts[2:]), True
    return "/".join(parts), False


def _elems(shape, spec, sizes):
    n = 1
    for dim, ax in zip(shape, spec):
        n *= dim // sharding.axes_size(sizes, sharding.entry_axes(ax))
    return n


def _cases():
    for arch in torch_configs.ALIASES:
        for shape in SHAPES:
            if shape == "long_500k" and specs.LONG_DECODE[arch] is None:
                continue
            yield arch, shape


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", list(_cases()))
def test_decode_plan_matches_reference(arch, shape, mesh_name):
    from repro import configs as jax_configs
    from repro.distributed import sharding as JS
    from repro.launch import specs as jax_specs
    sizes = MESHES[mesh_name]
    jmesh = _jax_mesh(sizes)
    ct = specs.maybe_long_variant(torch_configs.get_config(arch), shape)
    cj = jax_specs.maybe_long_variant(jax_configs.get_config(arch), shape)
    s = specs.INPUT_SHAPES[shape]["seq"]
    m = sizes["model"]
    states = 0
    for b in BATCHES:
        got = sharding.decode_rules(ct, sizes, batch_size=b)["decode_cp"]
        want = JS.decode_rules(cj, jmesh, batch_size=b)["decode_cp"]
        assert tuple(got["seq_axes"]) == tuple(want["seq_axes"])
        assert tuple(got["dp_axes"]) == tuple(want["dp_axes"])
        assert got["n_shards"] == want["n_shards"]
        # the spec every cache of the rule takes: the reference's
        # DecodeCPSpec batch and sequence axes
        spec = sharding.decode_cp_spec(got, length=s)
        assert spec.seq_axes == tuple(want["seq_axes"])
        dp = tuple(want["dp_axes"])
        assert spec.batch == (None if not dp else dp[0] if len(dp) == 1
                              else dp)
        assert spec.l_loc * spec.n_shards == s
        for variant in VARIANTS:
            if variant == "paged" and "attn" not in ct.layer_kinds():
                continue
            cache = _port_cache(ct, b, s, variant)
            mine = sharding.cache_shardings(ct, sizes, cache, batch_size=b)
            ref = _ref_specs(cj, jmesh, _ref_cache(cj, b, s, variant), b)
            flat = TM.flatten(cache)
            for path, spec in mine.items():
                if path == "pt":           # the port's one shared table
                    assert spec == (None, None)
                    continue
                rpath, stacked = _ref_path(ct, path)
                rspec = ref[rpath]
                rspec = rspec[1:] if stacked else rspec
                rspec = rspec + (None,) * (len(spec) - len(rspec))
                name = path.rsplit(".", 1)[-1]
                if name not in STATE_LEAVES:
                    assert spec == rspec, (path, spec, rspec)
                    continue
                # recurrent state: heads (port) vs last dividing dim (ref)
                states += 1
                assert spec[0] == rspec[0], (path, spec, rspec)
                shape_ = tuple(flat[path].shape)
                if "model" in spec and "model" in rspec:
                    assert _elems(shape_, spec, sizes) == \
                        _elems(shape_, rspec, sizes), (path, spec, rspec)
                elif "model" not in spec:
                    dim = len(shape_) - 1 if name == "conv" else 1
                    assert shape_[dim] % m, (path, spec)
    kinds = set(ct.layer_kinds())
    assert bool(states) == bool(kinds & {"mamba2", "mlstm", "slstm"})


def test_state_layout_is_the_heads_where_the_reference_takes_another_dim():
    """The stated difference, named: zamba2's SSM state (B, H, N, P) goes
    over "model" on H in the port and on P in the reference, the same
    1/16 of it on each rank."""
    from repro import configs as jax_configs
    from repro.distributed import sharding as JS
    sizes = MESHES["16x16"]
    ct = torch_configs.get_config("zamba2-1.2b")
    cj = jax_configs.get_config("zamba2-1.2b")
    mine = sharding.cache_shardings(ct, sizes, _port_cache(ct, 128, 64,
                                                           "bf16"),
                                    batch_size=128)
    ref = _ref_specs(cj, _jax_mesh(sizes), _ref_cache(cj, 128, 64, "bf16"),
                     128)
    assert mine["layers.0.h"] == ("data", "model", None, None)
    assert ref["layers/0/h"] == ("data", None, None, "model")


@pytest.mark.parametrize("arch", list(torch_configs.ALIASES))
def test_serve_layout_holds_the_model_axis_only(arch):
    """The serving layout of the reference's dry run: the plan with
    ``fsdp=False`` (no data entry on any leaf), each "model" entry held as
    ``tp_holds`` says; on (16, 16) the configs whose q heads or widths do
    not divide the axis raise, naming their reason (minicpm-2b and
    llama4-scout: slice 6b-iii)."""
    from repro_torch.distributed import fsdp
    cfg = torch_configs.get_config(arch)
    for name in ("1x4", "2x2", "16x16"):
        sizes = MESHES[name]
        why = sharding.tp_refusal(cfg, sizes)
        if why:
            with pytest.raises(ValueError, match="does not divide|do not "
                                                 "divide"):
                fsdp.serve_layout(cfg, sizes)
            if arch in ("minicpm-2b", "llama4-scout-17b-a16e"):
                assert "6b-iii" in why
            continue
        lay = fsdp.serve_layout(cfg, sizes)
        holds = sharding.tp_holds(cfg, sizes)
        plan = sharding.param_shardings(cfg, sizes, fsdp=False)
        for path, spec in lay.held.items():
            assert all("data" not in sharding.entry_axes(a) for a in spec)
            if holds.get(path) and not path.endswith("slstm.r"):
                assert spec == plan[path], path
            elif not holds.get(path):
                assert spec == sharding.strip_axis(plan[path], "model")
