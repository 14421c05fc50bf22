"""The port's recurrent blocks, plain MLP and cross attention against the
JAX package on the CPU.

Each test makes its inputs with numpy from a seed and runs the JAX
function (``repro.models.ssm``, ``xlstm``, ``mlp``, ``attention``) and its
counterpart in ``repro_torch.models`` on them, the parameters the JAX
``init_*``'s moved over as numpy.  Everything is f32; outputs agree to
rtol = atol = 2e-4 (XLA and PyTorch sum in different orders).  The chunked
scans are also held to their step recurrences, and the training passes to
a chain of decode steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import mlp as JMLP  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs as torch_configs  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import mlp as TMLP  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops, which intra-op threads only slow (several test processes
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _t(tree):
    """A JAX parameter dict -> the same dict of f32 torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _cfgs(arch, **changes):
    cj = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                             **changes)
    ct = dataclasses.replace(torch_configs.get_config(arch).reduced(),
                             **changes)
    return cj, ct


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# activations, the plain MLP and cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activation_matches_jax(act):
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    want = np.asarray(JC.ACTIVATIONS[act](jnp.asarray(x)))
    got = TC.ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    # XLA's f32 tanh is its own approximation: a few ulps of 1 in the cdf
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_plain_mlp_matches_jax(act):
    pj = JMLP.init_mlp(jax.random.key(1), 32, 96)
    x = _randn(np.random.default_rng(0), 2, 5, 32)
    want = JMLP.mlp(pj, jnp.asarray(x), act=act)
    got = TMLP.mlp(_t(pj), torch.from_numpy(x), act=act)
    _close(got, want)
    assert {k: {n: tuple(v.shape) for n, v in p.items()}
            for k, p in pj.items()} == TMLP.mlp_shapes(32, 96)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_gated_mlp_under_other_activations_matches_jax(act):
    pj = JMLP.init_gated_mlp(jax.random.key(2), 32, 64)
    x = _randn(np.random.default_rng(1), 3, 4, 32)
    _close(TMLP.gated_mlp(_t(pj), torch.from_numpy(x), act=act),
           JMLP.gated_mlp(pj, jnp.asarray(x), act=act))


@pytest.mark.parametrize("n_kv", [4, 2])
def test_cross_attend_matches_jax(n_kv):
    """Whisper's cross attention over precomputed memory K/V (and under
    GQA, which Whisper does not use but the function takes)."""
    cj, ct = _cfgs("whisper-base", n_kv_heads=n_kv)
    pj = JA.init_attention(jax.random.key(3), cj.d_model, cj.n_heads,
                           cj.n_kv_heads, cj.hd, qkv_bias=True)
    rng = np.random.default_rng(2)
    mem = _randn(rng, 2, 11, cj.d_model)
    x = _randn(rng, 2, 5, cj.d_model)
    mkv_j = JA.memory_kv(pj, jnp.asarray(mem), cj)
    mkv_t = TA.memory_kv(_t(pj), torch.from_numpy(mem), ct)
    for a, b in zip(mkv_t, mkv_j):
        _close(a, b)
    _close(TA.cross_attend(_t(pj), torch.from_numpy(x), mkv_t, ct),
           JA.cross_attend(pj, jnp.asarray(x), mkv_j, cj))


def test_attend_train_without_rope_matches_jax():
    """``use_rope=False`` (Whisper's self attention), causal and
    bidirectional."""
    cj, ct = _cfgs("whisper-base")
    pj = JA.init_attention(jax.random.key(4), cj.d_model, cj.n_heads,
                           cj.n_kv_heads, cj.hd, qkv_bias=True)
    x = _randn(np.random.default_rng(3), 2, 24, cj.d_model)
    for bidi in (False, True):
        want = JA.attend_train(pj, jnp.asarray(x), None, None, cj,
                               use_rope=False, bidirectional=bidi)
        got = TA.attend_train(_t(pj), torch.from_numpy(x), None, None, ct,
                              use_rope=False, bidirectional=bidi)
        _close(got, want)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, s=32, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    x = _randn(rng, b, s, h, p)
    log_a = -np.abs(_randn(rng, b, s, h, scale=0.3))
    bb, cc = _randn(rng, b, s, h, n), _randn(rng, b, s, h, n)
    h0 = _randn(rng, b, h, n, p)
    return x, log_a, bb, cc, h0


def _ssd_steps(x, log_a, b, c, h0):
    """The recurrence h <- exp(log_a) h + b (x) x, y = c . h, in f64."""
    hh = h0.astype(np.float64)
    ys = []
    for t in range(x.shape[1]):
        hh = (np.exp(log_a[:, t])[:, :, None, None] * hh
              + np.einsum("bhn,bhp->bhnp", b[:, t], x[:, t]))
        ys.append(np.einsum("bhn,bhnp->bhp", c[:, t], hh))
    return np.stack(ys, 1), hh


@pytest.mark.parametrize("chunk,with_h0", [(8, False), (8, True),
                                           (32, True), (64, False)])
def test_ssd_chunked_matches_step_recurrence_and_jax(chunk, with_h0):
    """Both chunked scans against the step recurrence (a chunk longer
    than the sequence takes the whole sequence, as the reference's)."""
    x, log_a, b, c, h0 = _ssd_inputs(chunk)
    if not with_h0:
        h0 = np.zeros_like(h0)
    want_y, want_h = _ssd_steps(x, log_a, b, c, h0)
    kw = dict(chunk=chunk)
    yj, hj = JS.ssd_chunked(*map(jnp.asarray, (x, log_a, b, c)),
                            h0=jnp.asarray(h0) if with_h0 else None, **kw)
    yt, ht = TS.ssd_chunked(*map(torch.from_numpy, (x, log_a, b, c)),
                            h0=torch.from_numpy(h0) if with_h0 else None,
                            **kw)
    for got in ((yt, ht), (yj, hj)):
        _close(got[0], want_y)
        _close(got[1], want_h)
    _close(yt, yj)
    _close(ht, hj)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x, log_a, b, c, _ = _ssd_inputs(0, s=24)
    with pytest.raises(ValueError, match="divisible"):
        TS.ssd_chunked(*map(torch.from_numpy, (x, log_a, b, c)), chunk=16)


def _mamba(seed=5):
    cj, ct = _cfgs("zamba2-1.2b")
    pj = JS.init_mamba2(jax.random.key(seed), cj.d_model,
                        d_state=cj.ssm_state, n_heads=cj.ssm_heads,
                        head_dim=cj.ssm_head_dim, n_groups=cj.ssm_groups,
                        conv_width=cj.ssm_conv_width)
    return cj, ct, pj


def test_mamba2_shapes_are_init_mamba2s():
    cj, _, pj = _mamba()
    got = TS.mamba2_shapes(cj.d_model, d_state=cj.ssm_state,
                           n_heads=cj.ssm_heads, head_dim=cj.ssm_head_dim,
                           n_groups=cj.ssm_groups,
                           conv_width=cj.ssm_conv_width)
    flat = jax.tree_util.tree_flatten_with_path(pj)[0]
    want = {tuple(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in flat}
    have = {}
    for k, v in got.items():
        if isinstance(v, dict):
            have.update({(k, n): s for n, s in v.items()})
        else:
            have[(k,)] = v
    assert have == want


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_train_matches_jax(groups):
    cj, ct, _ = _mamba()
    cj = dataclasses.replace(cj, ssm_groups=groups)
    ct = dataclasses.replace(ct, ssm_groups=groups)
    pj = JS.init_mamba2(jax.random.key(6), cj.d_model, d_state=cj.ssm_state,
                        n_heads=cj.ssm_heads, head_dim=cj.ssm_head_dim,
                        n_groups=groups, conv_width=cj.ssm_conv_width)
    x = _randn(np.random.default_rng(4), 2, 32, cj.d_model)
    _close(TS.mamba2_train(_t(pj), torch.from_numpy(x), ct),
           JS.mamba2_train(pj, jnp.asarray(x), cj))


def test_mamba2_decode_matches_jax_and_train():
    """A chain of decode steps from the zero state: each step's output and
    state equal the JAX step's, and the outputs equal the training
    pass's."""
    cj, ct, pj = _mamba()
    pt = _t(pj)
    x = _randn(np.random.default_rng(5), 2, 16, cj.d_model)
    sj = JS.init_mamba2_state(2, cj, jnp.float32)
    st = TS.init_mamba2_state(2, ct)
    outs = []
    for i in range(x.shape[1]):
        yj, sj = JS.mamba2_decode(pj, jnp.asarray(x[:, i:i + 1]), sj, cj)
        yt, st = TS.mamba2_decode(pt, torch.from_numpy(x[:, i:i + 1]), st,
                                  ct)
        _close(yt, yj)
        outs.append(yt)
    for name in ("h", "conv"):
        _close(st[name], sj[name])
    _close(torch.cat(outs, 1),
           TS.mamba2_train(pt, torch.from_numpy(x), ct))


def test_softplus_is_logaddexp_above_twenty():
    x = torch.tensor([-30.0, 0.0, 19.0, 25.0, 80.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TS.softplus(x).numpy(), want, rtol=1e-7)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(seed, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, b, s, h, d) for _ in range(3))
    log_f = -np.abs(_randn(rng, b, s, h, scale=0.5))
    log_i = _randn(rng, b, s, h)
    return q, k, v, log_f, log_i


def _mlstm_steps(q, k, v, log_f, log_i, state=None):
    """The stabilised recurrence one step at a time, in f64 (mlstm_decode's
    arithmetic)."""
    b, s, h, d = q.shape
    if state is None:
        cc, nn, m = (np.zeros((b, h, d, d)), np.zeros((b, h, d)),
                     np.full((b, h), -1e30))
    else:
        cc, nn, m = (np.asarray(t, np.float64) for t in state)
    ys = []
    for t in range(s):
        m_new = np.maximum(log_f[:, t] + m, log_i[:, t])
        f_s = np.exp(log_f[:, t] + m - m_new)
        i_s = np.exp(log_i[:, t] - m_new)
        cc = (f_s[..., None, None] * cc + i_s[..., None, None]
              * np.einsum("bhd,bhe->bhde", v[:, t], k[:, t]))
        nn = f_s[..., None] * nn + i_s[..., None] * k[:, t]
        qs = q[:, t] * d ** -0.5
        num = np.einsum("bhde,bhe->bhd", cc, qs)
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", nn, qs)),
                         np.exp(-m_new))
        ys.append(num / den[..., None])
        m = m_new
    return np.stack(ys, 1), (cc, nn, m)


@pytest.mark.parametrize("chunk,with_state", [(8, False), (8, True),
                                              (32, False)])
def test_mlstm_chunked_matches_steps_and_jax(chunk, with_state):
    """The chunked mLSTM (stabiliser from the -1e30 sentinel, -inf
    within-chunk mask) against the step recurrence and the JAX scan; the
    final (C, n, m) too.  With a state, the first call's final state
    carries into a second call."""
    q, k, v, log_f, log_i = _mlstm_inputs(chunk)
    state_j = state_t = state_np = None
    if with_state:
        pre = _mlstm_inputs(99)
        _, state_j = JX._mlstm_chunked(*map(jnp.asarray, pre), chunk=chunk)
        _, state_t = TX.mlstm_chunked(*map(torch.from_numpy, pre),
                                      chunk=chunk)
        _, state_np = _mlstm_steps(*pre)
    yj, fj = JX._mlstm_chunked(*map(jnp.asarray, (q, k, v, log_f, log_i)),
                               chunk=chunk, state=state_j)
    yt, ft = TX.mlstm_chunked(*map(torch.from_numpy,
                                   (q, k, v, log_f, log_i)),
                              chunk=chunk, state=state_t)
    want_y, want_f = _mlstm_steps(q, k, v, log_f, log_i, state_np)
    assert torch.isfinite(yt).all()
    _close(yt, want_y)
    _close(yt, yj)
    for a, b, c in zip(ft, fj, want_f):
        _close(a, b)
        _close(a, c)


def _mlstm_params(cfg, seed=7):
    return JX.init_mlstm(jax.random.key(seed), cfg.d_model,
                         n_heads=cfg.n_heads, expand=cfg.lstm_expand,
                         conv_width=cfg.ssm_conv_width)


def test_mlstm_train_matches_jax():
    cj, ct = _cfgs("xlstm-1.3b")
    pj = _mlstm_params(cj)
    x = _randn(np.random.default_rng(6), 2, 32, cj.d_model)
    _close(TX.mlstm_train(_t(pj), torch.from_numpy(x), ct),
           JX.mlstm_train(pj, jnp.asarray(x), cj))


def test_mlstm_decode_matches_jax_and_train():
    cj, ct = _cfgs("xlstm-1.3b")
    pj = _mlstm_params(cj)
    pt = _t(pj)
    x = _randn(np.random.default_rng(7), 2, 16, cj.d_model)
    sj = JX.init_mlstm_state(2, cj.d_model, cj.n_heads,
                             expand=cj.lstm_expand,
                             conv_width=cj.ssm_conv_width)
    st = TX.init_mlstm_state(2, ct.d_model, ct.n_heads,
                             expand=ct.lstm_expand,
                             conv_width=ct.ssm_conv_width)
    assert float(st["m"][0, 0]) == float(np.float32(-1e30)) == \
        float(sj["m"][0, 0])
    outs = []
    for i in range(x.shape[1]):
        yj, sj = JX.mlstm_decode(pj, jnp.asarray(x[:, i:i + 1]), sj, cj)
        yt, st = TX.mlstm_decode(pt, torch.from_numpy(x[:, i:i + 1]), st,
                                 ct)
        _close(yt, yj)
        outs.append(yt)
    for name in ("C", "n", "m", "conv"):
        _close(st[name], sj[name])
    _close(torch.cat(outs, 1), TX.mlstm_train(pt, torch.from_numpy(x), ct))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_params(cfg, seed=8):
    return JX.init_slstm(jax.random.key(seed), cfg.d_model,
                         n_heads=cfg.n_heads)


@pytest.mark.parametrize("d_model", [256, 200, 48])
def test_slstm_shapes_round_d_ff_as_init_slstm(d_model):
    pj = JX.init_slstm(jax.random.key(0), d_model, n_heads=4)
    got = TX.slstm_shapes(d_model, n_heads=4)
    assert got["r"] == pj["r"].shape
    for name in ("w_in", "ff_gate", "ff_up", "ff_down"):
        assert {k: tuple(v.shape) for k, v in pj[name].items()} == got[name]


def test_slstm_train_matches_jax():
    cj, ct = _cfgs("xlstm-1.3b")
    pj = _slstm_params(cj)
    x = _randn(np.random.default_rng(8), 2, 24, cj.d_model)
    _close(TX.slstm_train(_t(pj), torch.from_numpy(x), ct),
           JX.slstm_train(pj, jnp.asarray(x), cj))


def test_slstm_decode_matches_jax_and_train():
    cj, ct = _cfgs("xlstm-1.3b")
    pj = _slstm_params(cj)
    pt = _t(pj)
    x = _randn(np.random.default_rng(9), 2, 12, cj.d_model)
    sj = JX.init_slstm_state(2, cj.d_model, cj.n_heads)
    st = TX.init_slstm_state(2, ct.d_model, ct.n_heads)
    assert float(st["n"].min()) == 1.0 and float(st["m"].abs().max()) == 0
    outs = []
    for i in range(x.shape[1]):
        yj, sj = JX.slstm_decode(pj, jnp.asarray(x[:, i:i + 1]), sj, cj)
        yt, st = TX.slstm_decode(pt, torch.from_numpy(x[:, i:i + 1]), st,
                                 ct)
        _close(yt, yj)
        outs.append(yt)
    for name in ("h", "c", "n", "m"):
        _close(st[name], sj[name])
    _close(torch.cat(outs, 1), TX.slstm_train(pt, torch.from_numpy(x), ct))


def test_causal_conv_state_carries_across_calls():
    """Two calls with the state between them equal one call over the whole
    sequence (the decode path's conv), and both equal the JAX conv."""
    rng = np.random.default_rng(10)
    x, w, b = _randn(rng, 2, 10, 6), _randn(rng, 4, 6), _randn(rng, 6)
    yw, _ = TS.causal_conv(*map(torch.from_numpy, (x, w, b)))
    y1, s1 = TS.causal_conv(*map(torch.from_numpy, (x[:, :7], w, b)))
    y2, _ = TS.causal_conv(torch.from_numpy(x[:, 7:]), torch.from_numpy(w),
                           torch.from_numpy(b), s1)
    _close(torch.cat([y1, y2], 1), yw, rtol=1e-6, atol=1e-6)
    yj, _ = JS._causal_conv(*map(jnp.asarray, (x, w, b)))
    _close(yw, yj, rtol=1e-6, atol=1e-6)


def test_ssd_chunked_gradient_stays_finite_where_the_decay_overflows():
    """At a full-size chunk the decay's exponent above the diagonal,
    cum_i - cum_j, passes f32's exp range (88).  The reference masks the
    product, where(mask, exp(.), 0), whose backward is 0 * inf = NaN: its
    gradient is NaN here (a reference fault).  The port masks the exponent:
    the same forward, and the gradients of the step recurrence."""
    x, log_a, b, c, _ = _ssd_inputs(11, s=64, h=2)
    log_a = np.full_like(log_a, -3.0)           # 64 steps: cum spans 189
    g = _randn(np.random.default_rng(12), *x.shape)

    def loss_j(x_, a_):
        return jnp.sum(JS.ssd_chunked(x_, a_, jnp.asarray(b), jnp.asarray(c),
                                      chunk=64)[0] * g)
    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(log_a))
    assert not all(np.isfinite(np.asarray(t)).all() for t in gj)

    def grads(fn):
        xt = torch.from_numpy(x).double().requires_grad_(True)
        at = torch.from_numpy(log_a).double().requires_grad_(True)
        y = fn(xt, at)
        return y, torch.autograd.grad((y * torch.from_numpy(g)).sum(),
                                      (xt, at))

    def steps(xt, at):
        hh = torch.zeros(x.shape[0], x.shape[2], b.shape[-1], x.shape[3],
                         dtype=torch.float64)
        ys = []
        for t in range(x.shape[1]):
            hh = (torch.exp(at[:, t])[:, :, None, None] * hh
                  + torch.einsum("bhn,bhp->bhnp",
                                 torch.from_numpy(b[:, t]).double(), xt[:, t]))
            ys.append(torch.einsum("bhn,bhnp->bhp",
                                   torch.from_numpy(c[:, t]).double(), hh))
        return torch.stack(ys, 1)
    y, gt = grads(lambda xt, at: TS.ssd_chunked(
        xt.float(), at.float(), torch.from_numpy(b), torch.from_numpy(c),
        chunk=64)[0])
    want_y, want = grads(steps)
    _close(y.detach(), want_y.detach())
    _close(y.detach(), JS.ssd_chunked(*map(jnp.asarray, (x, log_a, b, c)),
                                      chunk=64)[0])
    for got, w in zip(gt, want):
        assert torch.isfinite(got).all()
        _close(got, w)
