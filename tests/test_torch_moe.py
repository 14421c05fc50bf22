"""The port's MoE layer against ``repro.models.moe.moe_apply`` on the CPU.

Inputs are made with numpy from a seed and handed to both sides, in f32:
the output y and the load-balance loss agree to rtol = atol = 1e-5, and so
does every gradient of sum(y * w) + lb_loss, with respect to x and each of
the four leaves, against ``jax.grad`` (the two sum in different orders).
The cases take top_k 1 and 2 with capacity factors 1e-9 (each expert
holds top_k slots: most assignments drop), 1.25 (some drop) and 8.0 (none
do), over 21 tokens (3 x 7: no tile divides them).  Ties route as
``jax.lax.top_k`` does (the lower expert first), bf16 stays within the
tolerance stated at its test, and the port's init draws ``init_moe``'s
values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, F, E = 3, 7, 32, 48, 6


def _case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x, w


def _jax_objective(top_k, cf):
    def f(p, x, w):
        y, lb = jmoe.moe_apply(p, x, top_k=top_k, capacity_factor=cf)
        return jnp.sum(y * w) + lb
    return f


def _torch_objective(top_k, cf):
    def f(p, x, w):
        y, lb = moe.moe_apply(p, x, top_k=top_k, capacity_factor=cf)
        return torch.sum(y * w) + lb
    return f


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("cf", [1e-9, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_and_gradients_match_jax(top_k, cf):
    p, x, w = _case(10 * top_k + int(cf * 4))
    yj, lbj = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), top_k=top_k, capacity_factor=cf)
    pt = {k: _t(v, True) for k, v in p.items()}
    xt = _t(x, True)
    yt, lbt = moe.moe_apply(pt, xt, top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(float(lbt.detach()), float(lbj), **TOL)
    # the capacity the case exercises: drops at 1e-9 and 1.25, none at 8
    t = B * S
    cap = moe.capacity(t, top_k, E, cf)
    assert cap == min(int(max(top_k, cf * t * top_k / E)), t)
    _, eidx = moe.route(torch.softmax(xt.reshape(t, D) @ pt["router"], -1),
                        top_k)
    most = int(torch.bincount(eidx.reshape(-1), minlength=E).max())
    assert (most > cap) == (cf < 8.0)

    gj = jax.grad(_jax_objective(top_k, cf), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(w))
    obj = _torch_objective(top_k, cf)(pt, xt, _t(w))
    names = sorted(pt)
    got = torch.autograd.grad(obj, [pt[k] for k in names] + [xt])
    for name, g in zip(names + ["x"], got):
        want = gj[1] if name == "x" else gj[0][name]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), err_msg=name,
                                   **TOL)


def test_ties_route_to_the_lower_expert():
    """Zero rows (every probability equal) and an expert column duplicated
    (two experts tied on every token): the port chooses
    ``jax.lax.top_k``'s experts and gives the reference's outputs."""
    p, x, _ = _case(3)
    p["router"][:, 4] = p["router"][:, 1]
    x[0, :3] = 0.0
    x[2, 5] = 0.0
    xf = x.reshape(-1, D)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(p["router"]), -1)
    for top_k in (1, 2, 3):
        _, want = jax.lax.top_k(probs, top_k)
        _, got = moe.route(torch.from_numpy(np.array(probs)), top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(jax.lax.top_k(probs, 3)[1])[0].tolist() == [0, 1, 2]
    for top_k, cf in ((2, 1.25), (3, 8.0)):
        yj, lbj = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), top_k=top_k,
                                 capacity_factor=cf)
        yt, lbt = moe.moe_apply({k: _t(v) for k, v in p.items()}, _t(x),
                                top_k=top_k, capacity_factor=cf)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(float(lbt), float(lbj), **TOL)


# bf16 tolerance.  Both sides take the router in f32 and route alike; each
# expert product rounds to bf16 once (half a bf16 ulp, 2**-9 relative,
# where the two f32 sums straddle a rounding point), the activation and the
# gating each once more, and those roundings of h carry through the down
# product; the combine differs too: XLA adds the k gated rows one by one in
# bf16, the port sums them in f32 and rounds once.  The scale of all of it
# is the layer recomputed over absolute values, |y|_terms = sum over the k
# rows of |gate| * ((|x| |W_gate|) * (|x| |W_up|)) |W_down|: about (k + 6)
# roundings of 2**-9 of it, which 2**-6 covers for k = 2.  Held at
# 2**-6 * |y|_terms + 1e-5.
BF16_REL = 2.0 ** -6


def test_bf16_matches_jax_within_stated_tolerance():
    p, x, _ = _case(7)
    top_k, cf = 2, 0.75            # 5 slots an expert for 42 assignments
    pj = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    yj, lbj = jmoe.moe_apply(pj, jnp.asarray(x, jnp.bfloat16), top_k=top_k,
                             capacity_factor=cf)
    pt = {k: _t(v).bfloat16() for k, v in p.items()}
    yt, lbt = moe.moe_apply(pt, _t(x).bfloat16(), top_k=top_k,
                            capacity_factor=cf)
    assert yt.dtype == torch.bfloat16 and lbt.dtype == torch.float32
    np.testing.assert_allclose(float(lbt), float(lbj), **TOL)
    # |y|_terms: the same layer over absolute values, on the bf16 values
    pa = {k: v.float() for k, v in pt.items()}
    xa = _t(x).bfloat16().float().reshape(B * S, D)
    probs = torch.softmax(xa @ pa["router"], -1)
    gates, eidx = moe.route(probs, top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    y_terms = 0.0
    for j in range(top_k):
        e = eidx[:, j]
        h = torch.einsum("td,tdf->tf", xa.abs(), pa["w_gate"][e].abs()) * \
            torch.einsum("td,tdf->tf", xa.abs(), pa["w_up"][e].abs())
        y_terms = y_terms + gates[:, j, None] * torch.einsum(
            "tf,tfd->td", h, pa["w_down"][e].abs())
    y_terms = y_terms.reshape(B, S, D)
    diff = (yt.float() - torch.from_numpy(
        np.asarray(yj.astype(jnp.float32)))).abs()
    bound = BF16_REL * y_terms + 1e-5
    assert bool((diff <= bound).all()), float((diff / bound).max())
    # not vacuous: the same layer without its drops (capacity factor 8)
    # leaves the bound wherever a token lost an assignment
    y8, _ = moe.moe_apply(pt, _t(x).bfloat16(), top_k=top_k,
                          capacity_factor=8.0)
    diff8 = (y8.float() - torch.from_numpy(
        np.asarray(yj.astype(jnp.float32)))).abs()
    assert int((diff8 > bound).any(-1).sum()) >= 1


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_init_draws_init_moe_values(arch):
    """The port's init from a seed gives the experts' leaves of
    ``init_moe`` under the reference's key tree, within 4 f32 ulps (the
    truncated normal's log1p), at init_moe's spreads: router 0.02, w_gate
    and w_up 1/sqrt(d_model), w_down 1/sqrt(d_ff_expert)."""
    cj = jax_configs.get_config(arch).reduced()
    ct = torch_configs.get_config(arch).reduced()
    pj = JM.init_params(cj, jax.random.key(4))
    want = TM.flatten(bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, pj), device="cpu"))
    got = TM.flatten(TM.init_params(ct, 4, "cpu"))
    moe_paths = [k for k in got if ".moe." in k]
    assert len(moe_paths) == 4 * ct.n_layers
    for path in moe_paths:
        g = got[path].numpy().astype(np.float64)
        w = want[path].numpy().astype(np.float64)
        assert g.shape == w.shape
        ulps = np.abs(g - w) / np.spacing(np.abs(w).astype(np.float32))
        assert float(ulps.max()) <= 4, (path, float(ulps.max()))
        name = path.rsplit(".", 1)[-1]
        nominal = {"router": 0.02, "w_gate": ct.d_model ** -0.5,
                   "w_up": ct.d_model ** -0.5,
                   "w_down": ct.d_ff_expert ** -0.5}[name]
        assert float(np.abs(g).max()) <= 2.0 * nominal * (1 + 1e-6), path
        assert abs(g.std() - 0.88 * nominal) < 0.1 * nominal, path
    # init_moe itself, called alone on one key, is the same draw
    key = jax.random.split(jax.random.split(jax.random.key(4),
                                            ct.n_layers + 5)[0], 4)[1]
    direct = jmoe.init_moe(key, ct.d_model, ct.d_ff_expert, ct.n_experts)
    layer0 = bridge.params_from_jax(
        ct, jax.tree.map(np.asarray, pj), device="cpu")["layers"][0]["moe"]
    for name, leaf in direct.items():
        np.testing.assert_array_equal(np.asarray(leaf),
                                      layer0[name].numpy())


def test_cast_params_keeps_the_router_for_f32_routing():
    """A bf16 model casts the router with every matrix (as the JAX
    ``cast_params``); the layer routes on it in f32."""
    ct = dataclasses.replace(
        torch_configs.get_config("granite-moe-1b-a400m").reduced(),
        dtype="bfloat16")
    cast = TM.flatten(TM.cast_params(ct, TM.init_params(ct, 0, "cpu")))
    assert cast["layers.0.moe.router"].dtype == torch.bfloat16
    assert cast["layers.0.moe.w_down"].dtype == torch.bfloat16
    x = torch.randn(2, 5, ct.d_model).bfloat16()
    p = TM.unflatten(cast)["layers"][0]["moe"]
    y, lb = moe.moe_apply(p, x, top_k=ct.top_k)
    assert y.dtype == torch.bfloat16 and lb.dtype == torch.float32
