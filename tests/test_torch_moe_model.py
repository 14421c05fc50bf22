"""The port's MoE models against the JAX package on the CPU.

Reduced Granite-MoE (2 layers, 4 experts, top-2) and Llama-4-Scout (one
block cycle: three sliding-window layers and a global one, 4 experts,
top-1), each at its reduced capacity factor 8.0 (nothing drops) and at
the full configs' 1.25 (assignments drop: capacity is per call, so every
row of a call competes for it), with the JAX package's parameters moved
over by ``repro_torch.bridge``.  Forward logits, values and ``aux_loss``,
prefill then per-slot decode with the caches, and ``verify_step``'s
logits and pendings agree to 2e-4 (f32 on both sides; XLA and PyTorch sum
in different orders).  The engines are in ``test_torch_moe_engine.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
CASES = [(a, cf) for a in ARCHS for cf in (None, 1.25)]
IDS = [f"{a.split('-')[0]}-cf{cf or 'reduced'}" for a, cf in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


_MODELS = {}


def _models(arch, cf):
    """(JAX config, port config, JAX params, port params), cached."""
    if (arch, cf) not in _MODELS:
        over = {} if cf is None else dict(capacity_factor=cf)
        cj = dataclasses.replace(jax_config(arch).reduced(), **over)
        ct = dataclasses.replace(torch_config(arch).reduced(), **over)
        pj = JM.init_params(cj, jax.random.key(0))
        pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                    device="cpu")
        _MODELS[arch, cf] = (cj, ct, pj, pt)
    return _MODELS[arch, cf]


def _jax_layers(cache, cfg):
    """The JAX cache's layers as numpy dicts (scan stacks unstacked)."""
    layers = cache["layers"]
    out = []
    for i in range(cfg.n_layers):
        if isinstance(layers, tuple):
            cyc = len(cfg.block_cycle)
            src = {n: a[i // cyc] for n, a in layers[i % cyc].items()}
        else:
            src = layers[i]
        out.append({n: np.asarray(a) for n, a in src.items()
                    if n not in ("index", "pt")})
    return out


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_forward_with_aux_loss_matches_jax(arch, cf):
    cj, ct, pj, pt = _models(arch, cf)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cj.vocab_size, (3, 24)).astype(np.int32)
    oj = jax.jit(lambda p, t: JM.forward(cj, p, {"tokens": t}))(
        pj, jnp.asarray(toks))
    ot = TM.forward(ct, pt, {"tokens": torch.from_numpy(toks)})
    for k in ("logits", "value"):
        _close(ot[k].detach(), oj[k])
    aux = float(ot["aux_loss"])
    np.testing.assert_allclose(aux, float(oj["aux_loss"]), rtol=1e-5)
    # the load-balance loss of each layer is at least 1 (E sum f_e p_e
    # with f and p distributions), so the sum is at least n_layers
    assert aux >= ct.n_layers * (1 - 1e-6)


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_prefill_then_decode_matches_jax(arch, cf):
    cj, ct, pj, pt = _models(arch, cf)
    b, cache_len = 3, 32
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cj.vocab_size, (b, 24)).astype(np.int32)
    true_len = np.array([24, 20, 13], np.int32)
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
    pos = true_len.copy()
    for _ in range(3):
        nxt = rng.integers(0, cj.vocab_size, (b, 1)).astype(np.int32)
        oj, cache_j = jdecode(pj, cache_j, jnp.asarray(nxt),
                              jnp.asarray(pos))
        ot, cache_t = TM.decode_step(ct, pt, cache_t,
                                     {"tokens": torch.from_numpy(nxt)},
                                     torch.from_numpy(pos))
        _close(ot["logits"], oj["logits"])
        _close(ot["value"], oj["value"])
        pos = pos + 1
    for lt, lj in zip(cache_t["layers"], _jax_layers(cache_j, cj)):
        for n in ("k", "v"):
            _close(lt[n], lj[n])


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_verify_step_matches_jax(arch, cf):
    """``verify_step`` over B x K = 12 tokens in one MoE call (its drops
    differ from plain decode's, in the reference as here): logits and the
    pendings against the JAX package's on the same cache."""
    cj, ct, pj, pt = _models(arch, cf)
    b, length, kq = 3, 32, 4
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cj.vocab_size, (b, 20)).astype(np.int32)
    cache_j = JM.init_cache(cj, b, length, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, b, length, dtype=torch.float32,
                            device="cpu")
    _, cache_j = JM.prefill_step(cj, pj, cache_j, {"tokens": toks}, 0)
    TM.prefill_step(ct, pt, cache_t, {"tokens": torch.from_numpy(toks)}, 0)
    pos = np.array([20, 15, 18], np.int32)
    chunk = rng.integers(0, cj.vocab_size, (b, kq)).astype(np.int32)
    out_j, pend_j = JM.verify_step(cj, pj, cache_j,
                                   {"tokens": jnp.asarray(chunk)},
                                   jnp.asarray(pos), length)
    out_t, pend_t = TM.verify_step(ct, TM.cast_params(ct, pt), cache_t,
                                   {"tokens": torch.from_numpy(chunk)},
                                   torch.from_numpy(pos), length)
    _close(out_t["logits"], out_j["logits"])
    pj_layers = _jax_layers({"layers": pend_j}, cj) \
        if isinstance(pend_j, tuple) else \
        [{n: np.asarray(a) for n, a in p.items()} for p in pend_j]
    for got, want in zip(pend_t, pj_layers):
        assert sorted(got) == sorted(want)
        for n in got:
            _close(got[n], want[n])


def test_capacity_drops_change_decode_outputs():
    """The 1.25 cases exercise drops: at top-1 over 4 experts a 3-slot
    decode holds one slot an expert, so slots that pick one expert lose
    all but the first; at 8.0 nothing drops and each row is its own."""
    _, ct, _, pt = _models("llama4-scout-17b-a16e", 1.25)
    from repro_torch.models import moe
    assert moe.capacity(3, 1, 4, 1.25) == 1
    assert moe.capacity(3, 1, 4, 8.0) == 3
    x = torch.randn(3, 1, ct.d_model)
    x[1] = x[0]                          # two slots pick the same expert
    p = pt["layers"][0]["moe"]
    y, _ = moe.moe_apply(p, x, top_k=1, capacity_factor=1.25)
    y8, _ = moe.moe_apply(p, x, top_k=1, capacity_factor=8.0)
    torch.testing.assert_close(y[0], y8[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y8[1], y8[0], rtol=1e-6, atol=1e-6)
    assert y8[1].abs().max() > 0 and not y[1].any()
