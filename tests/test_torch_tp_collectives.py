"""Megatron-SP's collectives (``distributed/collectives.py``) over two gloo
ranks, against single-process math on the same numpy inputs.

* ``scatter_sum``: forward, rank r's slice along the sequence dim of the
  sum of the ranks' inputs; backward, every rank's input cotangent is the
  whole cotangent (the ranks' slices gathered).
* ``sum_over``: forward, the ranks' sum on every rank; backward the
  identity, for a loss every rank computes alike.
* ``max_over``: the ranks' elementwise max, without a gradient.
* ``gather_sum`` then ``scatter_sum`` (the SP pair around a block's
  products) is the sum of the ranks' partials, with the gradients of the
  chain rule.

Each call adds one to its kind in ``counts()``.
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 2
B, S, D = 2, 8, 3
TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((WORLD, B, S, D)).astype(np.float32),
            "c": rng.standard_normal((B, S, D)).astype(np.float32),
            "h": rng.standard_normal((WORLD, B, S // WORLD, D))
            .astype(np.float32),
            "w": rng.standard_normal((WORLD, D, D)).astype(np.float32)}


def _rank_main(rank, port, out_dir):
    from repro_torch.distributed import collectives
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        inp = _inputs()
        group = dist.group.WORLD
        sl = slice(rank * S // WORLD, (rank + 1) * S // WORLD)
        c = torch.from_numpy(inp["c"])
        out = {}
        collectives.reset_counts()

        x = torch.from_numpy(inp["x"][rank]).requires_grad_(True)
        y = collectives.scatter_sum(x, group, 1)
        (y * c[:, sl]).sum().backward()
        out["scatter_sum"] = (y.detach().numpy(), x.grad.numpy())
        out["scatter_counts"] = collectives.counts()

        collectives.reset_counts()
        x = torch.from_numpy(inp["x"][rank]).requires_grad_(True)
        y = collectives.sum_over(x, group)
        (y * c).sum().backward()
        out["sum_over"] = (y.detach().numpy(), x.grad.numpy())
        m = collectives.max_over(torch.from_numpy(inp["x"][rank]), group)
        out["max_over"] = (m.numpy(), m.requires_grad)
        out["sum_counts"] = collectives.counts()

        collectives.reset_counts()
        h = torch.from_numpy(inp["h"][rank]).requires_grad_(True)
        w = torch.from_numpy(inp["w"][rank]).requires_grad_(True)
        y = collectives.scatter_sum(collectives.gather_sum(h, group, 1) @ w,
                                    group, 1)
        (y * c[:, sl]).sum().backward()
        out["pair"] = (y.detach().numpy(), h.grad.numpy(), w.grad.numpy())
        out["pair_counts"] = collectives.counts()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpc")
    mp.spawn(_rank_main, args=(_free_port(), str(tmp)), nprocs=WORLD)
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _sl(r):
    return slice(r * S // WORLD, (r + 1) * S // WORLD)


def test_scatter_sum_forward_and_backward(ranks):
    inp = _inputs()
    total = inp["x"].sum(0)
    for r, res in enumerate(ranks):
        y, dx = res["scatter_sum"]
        np.testing.assert_allclose(y, total[:, _sl(r)], rtol=TOL, atol=TOL)
        # d/dx_r of sum_k <(sum x)[:, k], c[:, k]> is c, whole
        np.testing.assert_allclose(dx, inp["c"], rtol=TOL, atol=TOL)
        assert res["scatter_counts"] == {"all_gather": 1,
                                         "reduce_scatter": 1,
                                         "all_reduce": 0, "all_to_all": 0}


def test_sum_over_and_max_over(ranks):
    inp = _inputs()
    for res in ranks:
        y, dx = res["sum_over"]
        np.testing.assert_allclose(y, inp["x"].sum(0), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(dx, inp["c"], rtol=TOL, atol=TOL)
        m, needs_grad = res["max_over"]
        np.testing.assert_array_equal(m, inp["x"].max(0))
        assert not needs_grad
        assert res["sum_counts"] == {"all_gather": 0, "reduce_scatter": 0,
                                     "all_reduce": 2, "all_to_all": 0}


def test_gather_then_scatter_is_the_sum_of_partials(ranks):
    """y = RS(AG(h) @ w_r): the global function sum_r H @ w_r of the whole
    H (the ranks' h along the sequence); its gradients by the chain rule,
    in float64 numpy."""
    inp = _inputs()
    hh = np.concatenate(list(inp["h"].astype(np.float64)), axis=1)
    w = inp["w"].astype(np.float64)
    c = inp["c"].astype(np.float64)
    total = sum(hh @ w[k] for k in range(WORLD))
    dh = sum(c @ w[k].T for k in range(WORLD))
    for r, res in enumerate(ranks):
        y, gh, gw = res["pair"]
        np.testing.assert_allclose(y, total[:, _sl(r)], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gh, dh[:, _sl(r)], rtol=1e-5, atol=1e-5)
        want_w = np.einsum("bsi,bso->io", hh, c)
        np.testing.assert_allclose(gw, want_w, rtol=1e-5, atol=1e-5)
        assert res["pair_counts"] == {"all_gather": 2, "reduce_scatter": 2,
                                      "all_reduce": 0, "all_to_all": 0}
