"""The multi-leaf Shared-RMSProp of the port (``kernels/rmsprop_cuda.py``,
``csrc/rmsprop.cu``) and the optimizer's one-pass step on the CPU.

``plan`` lays an update's leaves out over launches of at most
``MAX_LEAVES`` leaves and over blocks of ``SPAN`` elements; a numpy model
of the kernel's block-to-leaf search shows that every element of every
leaf is visited exactly once.  ``optimizers.update_and_apply`` must give
the bits of ``opt.update`` + ``apply_updates`` for the three optimizers,
and the multi-leaf entries those of the one-leaf update.  The runners and
train steps that now go through it keep their JAX parity tests
(``test_torch_rl_runner.py``, ``test_torch_rl_replay.py``,
``test_torch_train.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import dispatch, rmsprop_cuda
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

N, SPAN = rmsprop_cuda.MAX_LEAVES, rmsprop_cuda.SPAN


def _yi6b_x16_sizes():
    """The 148 leaves of the train step's Yi-6B at full width x 16 layers
    (3,292,667,904 parameters)."""
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=16)
    return [math.prod(s) for s in M.flatten(M._shape_tree(cfg)).values()]


def _paper_net_sizes():
    """The paper's conv + LSTM net at 84 x 84: 13 leaves, 1,199,412
    parameters (``chip_smoke.py`` phase 9b)."""
    from repro_torch.core import prng
    from repro_torch.models import atari as nets
    params = nets.init_atari_params(prng.key(0), 3, input_hw=84,
                                    in_channels=1, lstm=True, device="cpu")
    return [t.numel() for t in M.flatten(params).values()]


LEAF_SETS = {
    "one element": [1],
    "odd sizes": [1, 3, 4, 663_552],
    "paper net (13)": _paper_net_sizes(),
    "yi-6b x16 (148)": _yi6b_x16_sizes(),
    "200 leaves": [(7 * i * i + 3 * i) % 70_001 + 1 for i in range(200)],
    "N + 1 leaves": [SPAN + 1] * (N + 1),
}


def _cover(sizes):
    """Per leaf, how often the kernel visits each element, from the plan
    and a model of the kernel: block b of a launch takes the last leaf
    whose first block is <= b (csrc/rmsprop.cu's binary search) and the
    SPAN elements from (b - first) * SPAN."""
    seen = [np.zeros(n, np.int64) for n in sizes]
    for lo, hi, blocks in rmsprop_cuda.plan(sizes):
        first = blocks[:-1]
        for b in range(blocks[-1]):
            leaf = lo + int(np.searchsorted(first, b, side="right")) - 1
            start = (b - int(first[leaf - lo])) * SPAN
            seen[leaf][start:start + SPAN] += 1
    return seen


@pytest.mark.parametrize("name", list(LEAF_SETS))
def test_plan_packs_leaves_and_blocks(name):
    sizes = LEAF_SETS[name]
    steps = rmsprop_cuda.plan(sizes)
    assert len(steps) == -(-len(sizes) // N)
    assert [lo for lo, _, _ in steps] == list(range(0, len(sizes), N))
    assert steps[-1][1] == len(sizes)
    for lo, hi, blocks in steps:
        assert 0 < hi - lo <= N and len(blocks) == hi - lo + 1
        assert blocks[0] == 0
        np.testing.assert_array_equal(
            np.diff(blocks), [-(-n // SPAN) for n in sizes[lo:hi]])
    if sum(sizes) <= 10_000_000:    # the 148-leaf table: counts above only
        assert all((s == 1).all() for s in _cover(sizes))


def test_plan_launch_counts():
    assert len(_paper_net_sizes()) == 13
    assert sum(_paper_net_sizes()) == 1_199_412
    assert len(rmsprop_cuda.plan(_paper_net_sizes())) == 1
    assert len(rmsprop_cuda.plan(_yi6b_x16_sizes())) == 3     # 64 + 64 + 20
    assert sum(_yi6b_x16_sizes()) == 3_292_667_904
    assert len(rmsprop_cuda.plan([1] * 200)) == 4
    with pytest.raises(ValueError, match="empty"):
        rmsprop_cuda.plan([4, 0])


def _tree(rng, sizes, scale=1.0, positive=False):
    shapes = [(n,) if n % 3 else (3, n // 3) for n in sizes]
    leaves = [scale * rng.standard_normal(s).astype(np.float32)
              for s in shapes]
    if positive:
        leaves = [np.abs(x) for x in leaves]
    return {"w": [torch.from_numpy(x) for x in leaves[:-1]],
            "b": {"last": torch.from_numpy(leaves[-1])}}


def _clone(tree):
    return M.tree_map(lambda t: t.clone(), tree)


@pytest.mark.parametrize("name", ["shared_rmsprop", "rmsprop",
                                  "momentum_sgd"])
def test_update_and_apply_equals_update_then_apply(name):
    rng = np.random.default_rng(3)
    sizes = [1, 3, 4, 4099, 663]
    params = _tree(rng, sizes)
    opt = opt_mod.OPTIMIZERS[name]()
    state = opt.init(params)
    # a non-zero accumulator first, then two steps of both routes
    first = opt.update(_tree(rng, sizes, 2.0), state, 1e-3)[1]
    p_a, s_a, p_b, s_b = (_clone(params), _clone(first), _clone(params),
                          _clone(first))
    for lr in (7e-3, 3e-3):
        grads = _tree(rng, sizes, 3.0)
        updates, s_a = opt.update(grads, s_a, lr)
        opt_mod.apply_updates(p_a, updates)
        s_b = opt_mod.update_and_apply(opt, p_b, grads, s_b, lr)
    got_a, got_b = opt_mod.leaves((p_a, s_a)), opt_mod.leaves((p_b, s_b))
    assert len(got_a) == len(got_b) == 2 * len(sizes)
    for a, b in zip(got_a, got_b):
        assert torch.equal(a, b)


def test_multi_entries_equal_the_one_leaf_update():
    rng = np.random.default_rng(5)
    sizes = [1, 3, 4, 5000, 77]
    g = opt_mod.leaves(_tree(rng, sizes, positive=True))
    grads = opt_mod.leaves(_tree(rng, sizes, 3.0))
    p = opt_mod.leaves(_tree(rng, sizes))
    one_g = [x.clone() for x in g]
    one_p = [x.clone() for x in p]
    one_u = []
    for x, d, q in zip(one_g, grads, one_p):
        _, u = dispatch.rmsprop_update(x, d, lr=7e-3, alpha=0.95, eps=0.1)
        q.sub_(u)
        one_u.append(u)
    multi_g = [x.clone() for x in g]
    upds = dispatch.rmsprop_update_multi(multi_g, grads, lr=7e-3,
                                         alpha=0.95, eps=0.1)
    apply_g, apply_p = [x.clone() for x in g], [x.clone() for x in p]
    dispatch.rmsprop_apply_multi(apply_p, apply_g, grads, lr=7e-3,
                                 alpha=0.95, eps=0.1)
    for i in range(len(sizes)):
        assert torch.equal(multi_g[i], one_g[i])
        assert torch.equal(upds[i], one_u[i])
        assert torch.equal(apply_g[i], one_g[i])
        assert torch.equal(apply_p[i], one_p[i])


def test_multi_entries_reject_bad_inputs():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="differ"):
        rmsprop_cuda.rmsprop_apply_multi([z], [z.clone()], [torch.zeros(5)],
                                         lr=1.0)
    with pytest.raises(ValueError, match="float32"):
        rmsprop_cuda.rmsprop_update_multi([z.double()], [z.double()],
                                          lr=1.0)
    with pytest.raises(ValueError, match="a leaf"):
        rmsprop_cuda.rmsprop_apply_multi([z], [z, z], [z, z], lr=1.0)
    assert rmsprop_cuda.rmsprop_update_multi([], [], lr=1.0) == []


def test_multi_counters_untouched_on_cpu():
    dispatch.reset_launch_counts()
    z = [torch.zeros(5), torch.zeros(2, 3)]
    dispatch.rmsprop_update_multi([t.clone() for t in z],
                                  [torch.ones_like(t) for t in z], lr=1.0)
    dispatch.rmsprop_apply_multi([t.clone() for t in z],
                                 [t.clone() for t in z],
                                 [torch.ones_like(t) for t in z], lr=1.0)
    counts = dispatch.launch_counts()
    assert counts["rmsprop_update_multi"] == counts["rmsprop_apply_multi"] \
        == counts["rmsprop"] == 0
