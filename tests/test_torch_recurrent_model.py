"""The port's recurrent, hybrid and encoder-decoder models against the JAX
package on the CPU.

Reduced zamba2-1.2b (two mamba2 layers and the shared attention block
after the second), xlstm-1.3b (four mLSTM layers), xlstm with the cycle
("mlstm", "slstm") (scan-stacked in the JAX tree, which the bridge
unstacks) and whisper-base (two encoder and two decoder layers), in f32
with the JAX package's parameters moved over by ``repro_torch.bridge``:
forward logits and values, a chain of decode steps (per-slot and
lockstep positions; whisper after ``prefill_cross``) and three Shared
RMSProp train steps agree with the JAX package's (logits to 2e-4,
parameters to 1e-5).  The port's own ``init_params`` draws the
reference's weights from its key tree within 4 f32 ulps, and
``param_shapes``/``param_count`` equal ``jax.eval_shape`` of the
reference's ``init_params`` for all ten configs, full and reduced.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import llm_a3c as jax_a3c  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops, which intra-op threads only slow (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MIXED = dict(block_cycle=("mlstm", "slstm"))
CASES = {"zamba2": ("zamba2-1.2b", {}), "xlstm": ("xlstm-1.3b", {}),
         "xlstm-mixed": ("xlstm-1.3b", MIXED),
         "whisper": ("whisper-base", {})}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _pair(case):
    arch, changes = CASES[case]
    cj = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                             **changes)
    ct = dataclasses.replace(torch_configs.get_config(arch).reduced(),
                             **changes)
    return cj, ct


_BRIDGED = {}


def _bridged(case):
    if case not in _BRIDGED:
        cj, ct = _pair(case)
        pj = JM.init_params(cj, jax.random.key(0))
        pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                    device="cpu")
        _BRIDGED[case] = cj, ct, pj, pt
    return _BRIDGED[case]


def _frames(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
            ).astype(np.float32)


def _batches(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.is_encdec:
        fr = _frames(cfg, b, seed)
        jb["enc_frames"], tb["enc_frames"] = jnp.asarray(fr), \
            torch.from_numpy(fr)
    return jb, tb


# ---------------------------------------------------------------------------
# layout and initialisation
# ---------------------------------------------------------------------------

def _jax_flat_shapes(cfg):
    """{path: shape} of the reference's ``init_params`` in the port's
    layout (scan-stacked layers unstacked), from ``jax.eval_shape``."""
    tree = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                          jax.random.key(0))
    layers = tree.get("layers")
    out = {k: tuple(v.shape) for k, v in TM.flatten(
        {k: v for k, v in tree.items() if k != "layers"}).items()}
    if layers is None:
        return out
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


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_param_shapes_and_count_match_jax_eval_shape(arch, reduced):
    cj, ct = jax_configs.get_config(arch), torch_configs.get_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    shapes = _jax_flat_shapes(cj)
    assert TM.param_shapes(ct) == shapes
    assert ct.param_count() == sum(math.prod(s) for s in shapes.values())


@pytest.mark.parametrize("arch,count", [("zamba2-1.2b", 1_104_939_904),
                                        ("xlstm-1.3b", 3_501_408_592),
                                        ("whisper-base", 70_686_720)])
def test_new_families_count_their_parameters(arch, count):
    assert torch_configs.get_config(arch).param_count() == count


@pytest.mark.parametrize("case,seed,part", [("zamba2", 0, True),
                                            ("zamba2", 3, False),
                                            ("xlstm", 0, True),
                                            ("xlstm-mixed", 1, True),
                                            ("whisper", 0, True),
                                            ("whisper", 2, False)])
def test_init_params_match_jax(case, seed, part):
    """Every leaf from the reference's key tree within 4 f32 ulps: the
    truncated normals (conv weights at 0.2, sLSTM's r at 1/sqrt(hd)),
    mamba2's A_log and its dt_bias from a uniform draw, mLSTM's down from
    fold_in(key, 99), the shared block from keys[-4], the
    encoder-decoder's own tree."""
    cj, ct = _pair(case)
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
        tiny = np.spacing(np.float32(np.finfo(np.float32).tiny))
        ulps = np.abs(g - w) / np.maximum(
            np.spacing(np.abs(w).astype(np.float32)), tiny)
        assert float(ulps.max()) <= 4, (path, float(ulps.max()))


def test_cast_params_keeps_vectors_f32():
    """bf16 casts every leaf of two or more dimensions (conv_w and sLSTM's
    r among them); A_log, D, dt_bias, biases and scales stay f32."""
    _, ct = _pair("xlstm-mixed")
    cast = TM.flatten(TM.cast_params(
        dataclasses.replace(ct, dtype="bfloat16"),
        TM.init_params(ct, 0, "cpu")))
    assert cast["layers.1.slstm.r"].dtype == torch.bfloat16
    assert cast["layers.0.mlstm.conv_w"].dtype == torch.bfloat16
    assert cast["layers.0.mlstm.w_i.b"].dtype == torch.float32
    _, cz = _pair("zamba2")
    cast = TM.flatten(TM.cast_params(
        dataclasses.replace(cz, dtype="bfloat16"),
        TM.init_params(cz, 0, "cpu")))
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        assert cast[f"layers.0.mamba.{name}"].dtype == torch.float32
    assert cast["shared_attn.mlp.gate.w"].dtype == torch.bfloat16


def test_bridge_unstacks_a_mixed_cycle_by_kind():
    """xlstm with ("mlstm", "slstm") over 4 layers is scan-stacked in the
    JAX tree (a tuple of two different block dicts, each with a leading
    2): layer i is entry i % 2 at index i // 2."""
    cj, ct, pj, pt = _bridged("xlstm-mixed")
    assert isinstance(pj["layers"], tuple) and len(pj["layers"]) == 2
    for i in range(ct.n_layers):
        kind = ct.layer_kinds()[i]
        assert kind in pt["layers"][i]
        leaf = "up_x" if kind == "mlstm" else "w_in"
        want = np.asarray(pj["layers"][i % 2][kind][leaf]["w"])[i // 2]
        got = pt["layers"][i][kind][leaf]["w"]
        np.testing.assert_array_equal(got.numpy(), want)
    st = bridge.opt_state_from_jax(ct, {"g": jax.tree.map(np.asarray, pj)},
                                   device="cpu")
    assert TM.flatten(st["g"]).keys() == TM.flatten(pt).keys()


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    cj, ct, pj, pt = _bridged(case)
    jb, tb = _batches(cj, 2, 32, 1)
    oj = JM.forward(cj, pj, jb)
    with torch.no_grad():
        ot = TM.forward(ct, pt, tb)
    for k in ("logits", "value", "aux_loss"):
        _close(ot[k], oj[k])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_chain_matches_jax_and_forward(case):
    """Decode steps from an empty cache (whisper after ``prefill_cross``),
    per-slot and lockstep positions in turn: every step's logits and
    values equal the JAX step's, and the chain's logits equal the port's
    own forward over the same tokens."""
    cj, ct, pj, pt = _bridged(case)
    b, n, cache_len = 2, 16, 24
    jb, tb = _batches(cj, b, n, 2)
    toks = np.asarray(jb["tokens"])
    cache_j = JM.init_cache(cj, b, cache_len, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, b, cache_len, dtype=torch.float32,
                            device="cpu")
    if cj.is_encdec:
        cache_j = JE.prefill_cross(cj, pj, cache_j, jb["enc_frames"])
        cache_t = TE.prefill_cross(ct, pt, cache_t, tb["enc_frames"])
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(
        cj, p, c, {"tokens": t}, pos))
    logits = []
    for i in range(n):
        pos = np.full(b, i, np.int32) if i % 2 else np.int32(i)
        oj, cache_j = step(pj, cache_j, jnp.asarray(toks[:, i:i + 1]),
                           jnp.asarray(pos))
        with torch.no_grad():
            ot, cache_t = TM.decode_step(
                ct, pt, cache_t, {"tokens": torch.from_numpy(toks[:, i:i + 1])},
                torch.as_tensor(pos))
        _close(ot["logits"], oj["logits"])
        _close(ot["value"], oj["value"])
        logits.append(ot["logits"])
    with torch.no_grad():
        full = TM.forward(ct, pt, tb)["logits"]
    _close(torch.cat(logits, 1), full)


def test_zamba2_cache_has_a_kv_cache_per_shared_application():
    _, ct = _pair("zamba2")
    full = torch_configs.get_config("zamba2-1.2b")
    assert full.n_layers // full.shared_attn_every == 6
    cache = TM.init_cache(ct, 3, 16, dtype=torch.int8, device="cpu")
    assert len(cache["shared"]) == ct.n_layers // ct.shared_attn_every == 1
    assert cache["shared"][0]["k"].shape == (3, 16, ct.n_kv_heads, ct.hd)
    for layer in cache["layers"]:
        assert layer["h"].dtype == layer["conv"].dtype == torch.float32
        assert layer["h"].shape == (3, ct.ssm_heads, ct.ssm_state,
                                    ct.ssm_head_dim)
    assert [len(TM.state_leaves(c)) for c in TM.slot_layers(cache)] == \
        [2, 2, 4]


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_prefill_and_verify_refuse_as_jax(case):
    """No chunked prefill or speculative verify over recurrent, shared or
    encoder-decoder caches, as in the reference (its prefill_step and
    verify_step raise NotImplementedError there too)."""
    cj, ct = _pair(case)
    assert not TM.supports_chunked_prefill(ct)
    assert not JM.supports_chunked_prefill(cj)
    assert llm_a3c.make_prefill_step(ct) is None
    assert jax_a3c.make_prefill_step(cj) is None
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="attention-only"):
        TM.prefill_step(ct, {}, {}, batch, 0)
    with pytest.raises(NotImplementedError, match="attention-only"):
        TM.verify_step(ct, {}, {}, batch, torch.zeros(1), 16)


def test_mlstm_chunk_must_divide_the_sequence():
    _, ct, _, pt = _bridged("xlstm")
    with torch.no_grad(), pytest.raises(ValueError, match="divisible"):
        TM.forward(ct, pt, {"tokens": torch.zeros((1, 24), dtype=torch.long)})


def test_encdec_forward_needs_frames():
    _, ct, _, pt = _bridged("whisper")
    with pytest.raises(KeyError, match="enc_frames"):
        TM.forward(ct, pt, {"tokens": torch.zeros((1, 4), dtype=torch.long)})


def test_sinusoid_matches_jax_on_the_positions_device():
    """The decoder's per-row sinusoid equals rows of the reference's table,
    and is built on its positions' device (a meta tensor stays meta: no
    copy through the host)."""
    pos = np.array([0, 7, 447, 1499], np.int64)
    want = np.asarray(JE._sinusoid(1500, 512))[pos]
    _close(TE.sinusoid_rows(torch.from_numpy(pos), 512), want,
           rtol=1e-6, atol=1e-6)
    _close(TE._sinusoid(1500, 512, "cpu"), JE._sinusoid(1500, 512),
           rtol=1e-6, atol=1e-6)
    out = TE.sinusoid_rows(torch.zeros(4, dtype=torch.long, device="meta"),
                           512)
    assert out.device.type == "meta" and out.shape == (4, 512)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

def _a3c_batch(cfg, seed, b=2, s=32, gamma=0.99):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    rewards = (rng.random((b, s)) < 0.3).astype(np.float32)
    rewards[:, -1] = 0.0
    done = np.zeros((b, s), np.float32)
    done[:, -1] = 1.0
    out = {"tokens": tokens.astype(np.int32), "rewards": rewards,
           "discounts": (gamma * (1.0 - done)).astype(np.float32)}
    if cfg.is_encdec:
        out["enc_frames"] = _frames(cfg, b, seed)
    return out


def _tb(b):
    out = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_shared_rmsprop_steps_match_jax(case):
    """``make_train_step`` against the JAX train step over three batches
    (whisper's carry ``enc_frames``): losses to rtol 1e-5, parameters to
    rtol 1e-5 (atol 1e-6), the RMSProp statistics within 1e-4 of each
    leaf's largest."""
    cj, ct = _pair(case)
    pj = JM.init_params(cj, jax.random.key(0))
    sj = {"g": jax.tree.map(jnp.zeros_like, pj)}
    lr0, total = 7e-4, 10
    step_j = jax.jit(jax_a3c.make_train_step(
        cj, jax_opt.shared_rmsprop(fused=False), lr0=lr0, total_steps=total))
    step_t = llm_a3c.make_train_step(ct, opt_mod.shared_rmsprop(), lr0=lr0,
                                     total_steps=total)
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    st = bridge.opt_state_from_jax(ct, jax.tree.map(np.asarray, sj),
                                   device="cpu")
    for i in range(3):
        b = _a3c_batch(cj, 20 + i)
        pj, sj, met_j = step_j(pj, sj, {k: jnp.asarray(v)
                                        for k, v in b.items()},
                               jnp.asarray(i))
        pt, st, met_t = step_t(pt, st, _tb(b), i)
        np.testing.assert_allclose(float(met_t["loss"]),
                                   float(met_j["loss"]), rtol=1e-5)
    want = TM.flatten(bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, pj), device="cpu"))
    for path, t in TM.flatten(pt).items():
        np.testing.assert_allclose(t.detach().numpy(), want[path],
                                   rtol=1e-5, atol=1e-6, err_msg=path)
    # the statistics sum squared gradients, whose summation-order noise is
    # absolute: held as the gradients are (max |diff| <= 1e-4 max |g|; a
    # leaf whose gradient is zero but for rounding, such as a key bias
    # under a softmax, below 1e-12, the square of a 1e-5 gradient error)
    want = TM.flatten(bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, sj["g"]), device="cpu"))
    for path, t in TM.flatten(st["g"]).items():
        w = want[path].numpy()
        diff = float(np.abs(t.numpy() - w).max())
        assert diff <= 1e-4 * max(float(np.abs(w).max()), 1e-8), \
            (path, diff)


@pytest.mark.parametrize("case", ["zamba2", "xlstm-mixed"])
def test_remat_gives_the_same_gradients(case):
    """``torch.utils.checkpoint`` around every block (the shared block's
    applications included) recomputes the same gradients."""
    _, ct = _pair(case)
    b = _tb(_a3c_batch(ct, 3))
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(ct, remat=remat)
        pt = TM.init_params(cfg, 0, "cpu")
        leaves = list(TM.flatten(pt).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = llm_a3c.a3c_token_loss(cfg, pt, b)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for g0, g1 in zip(grads[False], grads[True]):
        torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)
    assert any(float(g.abs().max()) > 0 for g in grads[True])


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_every_config_builds_runs_and_decodes(arch):
    """No config is refused any more: ``init_params``, ``forward``,
    ``init_cache`` and ``decode_step`` run for each of the ten reduced
    configs (whisper with frames and ``prefill_cross``), with finite
    logits of the right shape."""
    ct = torch_configs.get_config(arch).reduced()
    pt = TM.init_params(ct, 0, "cpu")
    b, s = 2, 16
    batch = {"tokens": torch.zeros((b, s), dtype=torch.long)}
    if ct.is_encdec:
        batch["enc_frames"] = torch.from_numpy(_frames(ct, b))
    with torch.no_grad():
        out = TM.forward(ct, pt, batch)
        cache = TM.init_cache(ct, b, 32, dtype=torch.float32, device="cpu")
        if ct.is_encdec:
            TE.prefill_cross(ct, pt, cache, batch["enc_frames"])
        step, _ = TM.decode_step(ct, TM.cast_params(ct, pt), cache,
                                 {"tokens": batch["tokens"][:, :1]},
                                 torch.zeros(b, dtype=torch.long))
    assert out["logits"].shape == (b, s, ct.vocab_size)
    assert step["logits"].shape == (b, 1, ct.vocab_size)
    assert torch.isfinite(out["logits"]).all()
    assert torch.isfinite(step["logits"]).all()
