"""The port's model layer against the JAX package on the CPU.

Reduced configs with the JAX package's own parameters, moved over by
``repro_torch.bridge``: chunked prefill and then per-slot and lockstep
decode steps give the same logits, values and caches to 2e-4 (f32 on both
sides; XLA and PyTorch sum in different orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _pair(arch, **changes):
    cj = jax_configs.get_config(arch).reduced()
    ct = torch_configs.get_config(arch).reduced()
    if changes:
        cj = dataclasses.replace(cj, **changes)
        ct = dataclasses.replace(ct, **changes)
    return cj, ct


def _bridged(cj, ct, seed=0):
    pj = JM.init_params(cj, jax.random.key(seed))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return pj, pt


def _jax_cache_layer(cache, i, cfg):
    """Layer i of a (possibly scan-stacked) JAX cache as numpy k, v."""
    layers = cache["layers"]
    if isinstance(layers, tuple):
        cyc = len(cfg.block_cycle)
        leaf = layers[i % cyc]
        return (np.asarray(leaf["k"][i // cyc]),
                np.asarray(leaf["v"][i // cyc]))
    return np.asarray(layers[i]["k"]), np.asarray(layers[i]["v"])


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def same_config(ct, cj) -> None:
    """The port's config has every field of the JAX one, equal, and its
    own further fields (Granite's multipliers, RMSNorm's epsilon, NoPE,
    dropless and held experts, the shared expert) at their defaults, which
    run what the JAX package runs."""
    dt, dj = dataclasses.asdict(ct), dataclasses.asdict(cj)
    assert {k: dt[k] for k in dj} == dj
    own = {f.name: f.default for f in dataclasses.fields(ct)
           if f.name not in dj}
    assert {k: dt[k] for k in own} == own


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_configs_equal_field_for_field(arch):
    cj, ct = jax_configs.get_config(arch), torch_configs.get_config(arch)
    same_config(ct, cj)
    same_config(ct.reduced(), cj.reduced())
    assert ct.hd == cj.hd and ct.layer_kinds() == cj.layer_kinds()


@pytest.mark.parametrize("arch,reduced", [("yi-6b", False),
                                          ("stablelm-1.6b", False),
                                          ("minicpm-2b", True),
                                          ("qwen2-72b", True),
                                          ("granite-moe-1b-a400m", False),
                                          ("granite-moe-1b-a400m", True)])
def test_param_count_matches_jax(arch, reduced):
    cj, ct = jax_configs.get_config(arch), torch_configs.get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert ct.param_count() == cj.param_count()


def test_yi6b_is_six_billion():
    assert torch_configs.get_config("yi-6b").param_count() == 6_061_039_616


def _jax_flat_shapes(cfg):
    """{path: shape} of ``JM.init_params(cfg, ...)`` in the port's layout
    (scan-stacked layers unstacked), from ``jax.eval_shape``: nothing is
    drawn, so full-size configs cost nothing."""
    tree = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                          jax.random.key(0))
    layers = tree["layers"]
    out = {}
    for name, leaf in TM.flatten({k: v for k, v in tree.items()
                                  if k != "layers"}).items():
        out[name] = tuple(leaf.shape)
    cyc = len(cfg.block_cycle)
    for i in range(cfg.n_layers):
        if isinstance(layers, tuple):
            flat = {k: tuple(v.shape[1:]) for k, v in
                    TM.flatten(dict(layers[i % cyc])).items()}
        else:
            flat = {k: tuple(v.shape) for k, v in
                    TM.flatten(dict(layers[i])).items()}
        out.update({f"layers.{i}.{k}": v for k, v in flat.items()})
    return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e", "qwen2-vl-72b"])
def test_ported_families_build(arch):
    """The MoE and M-RoPE families build at full size: every parameter's
    path and shape is the JAX package's, and ``param_count`` is the JAX
    config's."""
    cj, ct = jax_configs.get_config(arch), torch_configs.get_config(arch)
    assert TM.param_shapes(ct) == _jax_flat_shapes(cj)
    assert ct.param_count() == cj.param_count()
    if ct.n_experts:
        e, d, f = ct.n_experts, ct.d_model, ct.d_ff_expert
        shapes = TM.param_shapes(ct)
        assert shapes["layers.0.moe.w_down"] == (e, f, d)
        assert not any(".mlp." in k for k in shapes)


def test_init_params_layout_and_distributions():
    """The port's own init: the JAX layout (bridged shapes) and the JAX
    distributions (truncated normals of the same spread)."""
    cj, ct = _pair("yi-6b")
    pj, _ = _bridged(cj, ct)
    pt = TM.init_params(ct, seed=0, device="cpu")
    flat_t = TM.flatten(pt)
    assert {k: tuple(v.shape) for k, v in flat_t.items()} == \
        TM.param_shapes(ct)
    flat_j = TM.flatten(bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, pj), device="cpu"))
    for name in ("embed.table", "layers.0.attn.wq.w", "layers.1.mlp.down.w",
                 "lm_head.w"):
        sj, st = float(flat_j[name].std()), float(flat_t[name].std())
        assert abs(st - sj) < 0.05 * sj, (name, st, sj)
        # truncated at two nominal standard deviations, as jax's draw
        nominal = 0.02 if name == "embed.table" else \
            flat_t[name].shape[0] ** -0.5
        assert float(flat_t[name].abs().max()) <= 2.0 * nominal * (1 + 1e-6)
    assert torch.equal(flat_t["layers.0.ln1.scale"], torch.ones(ct.d_model))
    cast = TM.cast_params(dataclasses.replace(ct, dtype="bfloat16"), pt)
    flat_c = TM.flatten(cast)
    assert flat_c["layers.0.attn.wq.w"].dtype == torch.bfloat16
    assert flat_c["layers.0.ln1.scale"].dtype == torch.float32


@pytest.mark.parametrize("arch,seed,part", [("yi-6b", 0, True),
                                            ("yi-6b", 3, True),
                                            ("stablelm-1.6b", 0, True),
                                            ("stablelm-1.6b", 5, True),
                                            ("yi-6b", 0, False),
                                            ("granite-moe-1b-a400m", 0,
                                             True),
                                            ("granite-moe-1b-a400m", 2,
                                             False)])
def test_init_params_match_jax(arch, seed, part):
    """The port's own init from a seed is ``JM.init_params(cfg,
    jax.random.key(seed))`` leaf by leaf, within 4 f32 ulps (the
    truncated normal's log1p rounds differently on some inputs), under
    either threefry layout."""
    cj, ct = _pair(arch)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", part)
    try:
        pj = JM.init_params(cj, jax.random.key(seed))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    want = TM.flatten(bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, pj), device="cpu"))
    got = TM.flatten(TM.init_params(ct, seed, "cpu", partitionable=part))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        w, g = w.numpy().astype(np.float64), g.numpy().astype(np.float64)
        ulps = np.abs(g - w) / np.spacing(np.abs(w).astype(np.float32))
        assert float(ulps.max()) <= 4, (path, float(ulps.max()))


def test_bridge_rejects_a_mismatched_tree():
    cj, ct = _pair("yi-6b")
    pj = JM.init_params(cj, jax.random.key(0))
    tree = jax.tree.map(np.asarray, pj)
    other = dataclasses.replace(ct, d_ff=ct.d_ff * 2)
    with pytest.raises(ValueError, match="layout"):
        bridge.params_from_jax(other, tree, device="cpu")


# ---------------------------------------------------------------------------
# prefill + decode parity
# ---------------------------------------------------------------------------

_CASES = {
    "yi-6b": ("yi-6b", {}),                     # RMSNorm, GQA
    "stablelm-1.6b": ("stablelm-1.6b", {}),     # LayerNorm, partial rotary
    "qwen2-72b": ("qwen2-72b", {}),             # qkv bias
    "yi-6b-ring": ("yi-6b", dict(block_cycle=("attn_local",),
                                 sliding_window=8)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_prefill_then_decode_matches_jax(case):
    arch, changes = _CASES[case]
    cj, ct = _pair(arch, **changes)
    pj, pt = _bridged(cj, ct)
    b, cache_len = 2, 32
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cj.vocab_size, (b, 24)).astype(np.int32)
    true_len = np.array([24, 20], np.int32)

    cache_j = JM.init_cache(cj, b, cache_len, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, b, cache_len, dtype=torch.float32,
                            device="cpu")
    jprefill = jax.jit(lambda p, c, t, tl, pos0: JM.prefill_step(
        cj, p, c, {"tokens": t}, pos0, tl), static_argnums=(4,))
    for p0, c in ((0, 16), (16, 8)):
        oj, cache_j = jprefill(pj, cache_j, jnp.asarray(toks[:, p0:p0 + c]),
                               jnp.asarray(true_len), p0)
        ot, cache_t = TM.prefill_step(
            ct, pt, cache_t, {"tokens": torch.from_numpy(toks[:, p0:p0 + c])},
            p0, torch.from_numpy(true_len))
        _close(ot["logits"], oj["logits"])
        _close(ot["value"], oj["value"])

    jdecode = jax.jit(lambda p, c, t, pos: JM.decode_step(
        cj, p, c, {"tokens": t}, pos))
    # per-slot: row 1 continues at its true length 20, below row 0's 24
    pos = np.array([24, 20], np.int32)
    for step in range(3):
        nxt = rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
        oj, cache_j = jdecode(pj, cache_j, jnp.asarray(nxt),
                              jnp.asarray(pos))
        ot, cache_t = TM.decode_step(ct, pt, cache_t,
                                     {"tokens": torch.from_numpy(nxt)},
                                     torch.from_numpy(pos))
        _close(ot["logits"], oj["logits"])
        _close(ot["value"], oj["value"])
        pos = pos + 1
    # lockstep: one scalar position for every row
    nxt = rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
    oj, cache_j = jdecode(pj, cache_j, jnp.asarray(nxt), jnp.asarray(27))
    ot, cache_t = TM.decode_step(ct, pt, cache_t,
                                 {"tokens": torch.from_numpy(nxt)},
                                 torch.tensor(27))
    _close(ot["logits"], oj["logits"])
    for i in range(ct.n_layers):
        kj, vj = _jax_cache_layer(cache_j, i, cj)
        _close(cache_t["layers"][i]["k"], kj)
        _close(cache_t["layers"][i]["v"], vj)


def test_prefill_overflow_raises():
    _, ct = _pair("yi-6b")
    pt = TM.init_params(ct, seed=0, device="cpu")
    cache = TM.init_cache(ct, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="overflows"):
        TM.prefill_step(ct, pt, cache,
                        {"tokens": torch.zeros(1, 16, dtype=torch.long)}, 0)


def test_init_cache_rejects_int8():
    """The int8 storage check: torch.int8 makes a quantised cache (int8
    k/v with zero f32 scales ks/vs, rank-matched to the payload, as JAX
    ``init_kv_cache``); any other integer type is rejected."""
    _, ct = _pair("yi-6b")
    cache = TM.init_cache(ct, 1, 8, dtype=torch.int8, device="cpu")
    for layer in cache["layers"]:
        assert layer["k"].dtype == torch.int8 and layer["k"].shape == \
            (1, 8, ct.n_kv_heads, ct.hd)
        assert layer["ks"].dtype == torch.float32 and layer["ks"].shape == \
            (1, 8, ct.n_kv_heads, 1) and not layer["ks"].any()
    for bad in (torch.uint8, torch.int16):
        with pytest.raises(ValueError, match="kv_dtype"):
            TM.init_cache(ct, 1, 8, dtype=bad, device="cpu")
