"""The port's M-RoPE (Qwen2-VL) against the JAX package, on the CPU.

``mrope_cos_sin`` at random distinct temporal / height / width positions
against ``repro.models.common.mrope_cos_sin`` (atol 2e-6: the angles are
the same f32 products, torch's and XLA's cos and sin differ by an ulp or
so); with the three axes equal it is plain RoPE exactly.  Reduced
Qwen2-VL's training forward on ``embeds`` with (3, B, S) positions against
the JAX forward (2e-4, as ``test_torch_model.py``), its A3C loss with an
``actions`` batch and the gradients (rtol 1e-5; 1e-4 of each leaf's
largest), and the serve CLI's refusal of VLMs in the JAX CLI's words.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.core import llm_a3c as jax_a3c  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 24


def _positions(seed, b=B, s=S, hi=4096):
    """Distinct temporal, height and width ids a token (no two axes
    equal), as a vision segment would give them."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, hi, (3, b, s)).astype(np.int32)
    pos[1] = (pos[0] + 1 + rng.integers(0, hi // 2, (b, s))) % hi
    pos[2] = (pos[1] + 1 + rng.integers(0, hi // 4, (b, s))) % hi
    assert (pos[0] != pos[1]).all() and (pos[1] != pos[2]).all()
    return pos


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (64, (8, 12, 12))])
def test_mrope_cos_sin_matches_jax(head_dim, sections):
    pos = _positions(head_dim)
    cj, sj = jcm.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    ct, st = cm.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6,
                              sections)
    assert ct.shape == (B, S, head_dim // 2) and ct.dtype == torch.float32
    for got, want in ((ct, cj), (st, sj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)
    # each frequency slot follows its own axis: slot j of section a moves
    # with axis a's ids only
    moved = pos.copy()
    moved[2] += 7
    ct2, _ = cm.mrope_cos_sin(torch.from_numpy(moved), head_dim, 1e6,
                              sections)
    w = sections[0] + sections[1]
    assert torch.equal(ct2[..., :w], ct[..., :w])
    assert not torch.equal(ct2[..., w:], ct[..., w:])


def test_equal_positions_are_plain_rope():
    p = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5000, (B, S)).astype(np.int32))
    got = cm.mrope_cos_sin(p[None].expand(3, B, S), 128, 1e6, (16, 24, 24))
    want = cm.rope_cos_sin(p, 128, 1e6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mrope_refuses_other_position_shapes():
    with pytest.raises(ValueError, match="3, B, S"):
        cm.mrope_cos_sin(torch.zeros(2, B, S, dtype=torch.int32), 64, 1e6,
                         (8, 12, 12))


@pytest.fixture(scope="module")
def qwen2vl():
    cj = jax_configs.get_config(ARCH).reduced()
    ct = torch_configs.get_config(ARCH).reduced()
    assert ct.mrope_sections == (8, 12, 12) and ct.hd == 64
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj),
                                device="cpu")
    return cj, ct, pj, pt


def _embeds(seed, d):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((B, S, d))).astype(np.float32)


def test_forward_on_embeds_with_positions_matches_jax(qwen2vl):
    cj, ct, pj, pt = qwen2vl
    emb, pos = _embeds(1, cj.d_model), _positions(1, hi=64)
    oj = JM.forward(cj, pj, {"embeds": jnp.asarray(emb),
                             "positions": jnp.asarray(pos)})
    ot = TM.forward(ct, pt, {"embeds": torch.from_numpy(emb),
                             "positions": torch.from_numpy(pos)})
    for k in ("logits", "value"):
        np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]),
                                   **TOL)
    assert float(ot["aux_loss"]) == 0.0
    # without positions: arange(S) on all three axes, as the JAX forward
    oj0 = JM.forward(cj, pj, {"embeds": jnp.asarray(emb)})
    ot0 = TM.forward(ct, pt, {"embeds": torch.from_numpy(emb)})
    np.testing.assert_allclose(ot0["logits"].detach().numpy(),
                               np.asarray(oj0["logits"]), **TOL)
    # the positions matter: distinct ids give other logits than arange
    assert float((ot0["logits"] - ot["logits"]).abs().max()) > 1e-3


def test_loss_and_gradients_with_actions_match_jax(qwen2vl):
    """An embeds batch carries its actions (no tokens to roll)."""
    cj, ct, pj, pt = qwen2vl
    rng = np.random.default_rng(4)
    b = {"embeds": _embeds(2, cj.d_model), "positions": _positions(2, hi=64),
         "actions": rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32),
         "rewards": rng.random((B, S)).astype(np.float32),
         "discounts": np.full((B, S), 0.99, np.float32)}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["actions"] = tb["actions"].long()
    loss_j, met_j = jax_a3c.a3c_token_loss(cj, pj, jb)
    leaves = list(TM.flatten(pt).values())
    for t in leaves:
        t.requires_grad_(True)
    loss_t, met_t = llm_a3c.a3c_token_loss(ct, pt, tb)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    gj = TM.flatten(bridge.params_from_jax(ct, jax.tree.map(
        np.asarray, jax.grad(lambda p: jax_a3c.a3c_token_loss(
            cj, p, jb)[0])(pj)), device="cpu"))
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    for path, g in zip(TM.flatten(pt), grads):
        w = gj[path]
        if path == "embed.table":      # embeds batches never read it
            assert g is None and not w.any()
            continue
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (path, err)


def test_remat_forward_takes_the_tables(qwen2vl):
    _, ct, _, pt = qwen2vl
    emb, pos = _embeds(3, ct.d_model), _positions(3, hi=64)
    batch = {"embeds": torch.from_numpy(emb),
             "positions": torch.from_numpy(pos)}
    plain = TM.forward(ct, pt, batch)["logits"]
    remat = TM.forward(dataclasses.replace(ct, remat=True), pt,
                       batch)["logits"]
    assert torch.equal(plain, remat)


def test_serve_cli_refuses_vlm_as_the_jax_cli(capsys, monkeypatch):
    from repro.launch import serve as jax_serve
    argv = ["--arch", ARCH, "--reduced"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as want:
        jax_serve.main()
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "VLM" in str(got.value)
