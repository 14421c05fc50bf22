"""``launch/specs.py`` against the JAX package's: the tables
(``INPUT_SHAPES``, ``LONG_DECODE``, ``SW_WINDOW``), the sliding-window
variants, and for all ten configs at the four input shapes the input and
parameter specs' keys, shapes and dtypes against the reference's
``eval_shape`` (meta tensors here, ``ShapeDtypeStruct``s there).

The stated differences of the decode cache: the reference's int32
``index`` leaf of each KV cache has no counterpart (the port never reads
it), scan-stacked layers are one entry a layer here (the layer dim taken
off), mamba2's conv state is f32 (its inputs kept exactly) where the
reference's is the cache dtype, and the PRNG key is the port's two int64
words (``prng.key``) where the reference's is a typed key.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.distributed.sharding import scan_stacked  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ref_flat(tree, cfg):
    """{port path: (shape, dtype)} of a reference tree: "/"-paths as the
    port's "."-paths, a scan-stacked layer's leaves once per layer without
    the layer dim; the ``index`` leaves left out."""
    import jax
    out = {}
    stacked = scan_stacked(cfg)
    cyc = len(cfg.block_cycle)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[-1] == "index":
            continue
        if keys[0] == "layers" and stacked:
            j = int(keys[1])
            for c in range(leaf.shape[0]):
                out[".".join(["layers", str(c * cyc + j)] + keys[2:])] = \
                    (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_flat(tree):
    return {k: (tuple(v.shape), _dt(v)) for k, v in TM.flatten(tree).items()
            if torch.is_tensor(v)}


def test_tables_match_the_reference():
    from repro.launch import specs as jax_specs
    assert specs.INPUT_SHAPES == jax_specs.INPUT_SHAPES
    assert specs.LONG_DECODE == jax_specs.LONG_DECODE
    assert specs.SW_WINDOW == jax_specs.SW_WINDOW


@pytest.mark.parametrize("arch", list(torch_configs.ALIASES))
def test_long_variants_match_the_reference(arch):
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    for shape in specs.INPUT_SHAPES:
        ct = specs.maybe_long_variant(torch_configs.get_config(arch), shape)
        cj = jax_specs.maybe_long_variant(jax_configs.get_config(arch), shape)
        assert (ct.name, ct.block_cycle, ct.sliding_window) == \
            (cj.name, cj.block_cycle, cj.sliding_window)
    sw = specs.sliding_window_variant(torch_configs.get_config(arch))
    assert sw.name == arch + "+sw" and "attn" not in sw.block_cycle


@pytest.mark.parametrize("shape", list(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", list(torch_configs.ALIASES))
def test_input_specs_match_the_reference(arch, shape):
    import jax
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    ct = specs.maybe_long_variant(torch_configs.get_config(arch), shape)
    cj = jax_specs.maybe_long_variant(jax_configs.get_config(arch), shape)
    kind, got = specs.input_specs(ct, shape)
    jkind, want = jax_specs.input_specs(cj, shape)
    assert kind == jkind
    if kind != "decode":
        assert {k: (tuple(v.shape), _dt(v)) for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        return
    assert set(got) == set(want) == {"batch", "cache", "pos", "key"}
    assert _port_flat(got["batch"]) == _ref_flat(want["batch"], cj)
    assert (tuple(got["pos"].shape), _dt(got["pos"])) == \
        (tuple(want["pos"].shape), str(want["pos"].dtype))
    key = prng.key(0)
    assert (tuple(got["key"].shape), got["key"].dtype) == \
        (tuple(key.shape), key.dtype)
    assert jax.dtypes.issubdtype(want["key"].dtype, jax.dtypes.prng_key)
    mine, ref = _port_flat(got["cache"]), _ref_flat(want["cache"], cj)
    # the port's one page table ("pt") would be the reference's per-layer
    # tables; the decode shapes are contiguous, so neither has one
    assert set(mine) == set(ref)
    kinds = ct.layer_kinds()
    for path, (shp, dt) in mine.items():
        parts = path.split(".")
        conv = parts[0] == "layers" and parts[-1] == "conv" and \
            kinds[int(parts[1])] == "mamba2"
        want_dt = "float32" if conv else ref[path][1]
        assert (shp, dt) == (ref[path][0], want_dt), path
    assert all(t.device.type == "meta" for t in TM.flatten(got["cache"])
               .values() if torch.is_tensor(t))


@pytest.mark.parametrize("arch", list(torch_configs.ALIASES))
def test_params_specs_match_the_reference(arch):
    from repro import configs as jax_configs
    from repro.launch import specs as jax_specs
    ct = torch_configs.get_config(arch)
    cj = jax_configs.get_config(arch)
    got = _port_flat(specs.params_specs(ct))
    assert got == _ref_flat(jax_specs.params_specs(cj), cj)
    assert got == {k: (tuple(v), "float32")
                   for k, v in TM.param_shapes(ct).items()}
