"""Slice 6b-ii's blocks under tensor and sequence parallelism, over two
gloo ranks (a (data 1, model 2) view: every rank holds its half of the
sequence rows and of the heads or d_ff columns), against the JAX
package's whole functions on the same numpy inputs, f32, tolerance 1e-5.
Each block is driven as ``models/model.py`` drives it: the rows gathered
along the sequence (``gather_sum``), the block on this rank's leaves, the
partial sums reduce-scattered back to the rows (``scatter_sum``); the loss
is sum(out * c) over the global rows.  Each rank's leaves are cut here
from the whole ones, independently of ``fsdp``: mamba2's ``in_proj`` and
conv part by part (z | x | B | C | dt, x | B | C), the sLSTM's ``r`` over
its heads, every other split leaf a contiguous half.

* mamba2 (reduced zamba2: 4 heads, B and C gathered whole, the gated norm
  on rows gathered along the features) against ``repro.models.ssm``'s
  ``mamba2_train``;
* the mLSTM (reduced xlstm: 4 heads, ``w_i``/``w_f`` whole and narrowed,
  the norm on feature-gathered rows) against ``xlstm.mlstm_train``, and
  the sLSTM (its recurrence on 2 of 4 heads, no collective in the loop)
  against ``xlstm.slstm_train``;
* Whisper's cross-attention (reduced: 4 heads; the memory gathered from
  the ranks' frames, as ``encdec.encode`` gathers it) against
  ``attention.cross_attend`` over ``attention.memory_kv``, and its plain
  MLP (``fc2``'s whole bias added after the reduce-scatter) against
  ``mlp.mlp``.

Outputs, the rows' gradients (and the memory's) and every leaf's gradient,
a whole leaf's summed over the ranks inside the block; and each block's
route counters.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 2
B, S = 2, 32
TOL = 1e-5
ARCHS = {"mamba2": "zamba2-1.2b", "mlstm": "xlstm-1.3b",
         "slstm": "xlstm-1.3b", "cross": "whisper-base",
         "mlp": "whisper-base"}


def _cfg(pkg, block):
    return dataclasses.replace(pkg.get_config(ARCHS[block]).reduced(),
                               dtype="float32")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _perturb(tree, rng):
    """Every 1-D leaf but A_log and dt_bias moved off its init (zeros or
    ones), so a bias or scale taken at the wrong columns shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif v.ndim == 1 and k not in ("A_log", "dt_bias"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
        else:
            out[k] = v
    return out


def _params():
    """The blocks' whole parameters, from the reference's initialisers."""
    import jax
    from repro import configs
    from repro.models import attention as jattn
    from repro.models import mlp as jmlp
    from repro.models import ssm as jssm
    from repro.models import xlstm as jxl
    key = jax.random.key(0)
    z, x, w = (_cfg(configs, b) for b in ("mamba2", "mlstm", "cross"))
    p = {"mamba2": jssm.init_mamba2(
             key, z.d_model, d_state=z.ssm_state, n_heads=z.ssm_heads,
             head_dim=z.ssm_head_dim, n_groups=z.ssm_groups,
             conv_width=z.ssm_conv_width),
         "mlstm": jxl.init_mlstm(key, x.d_model, n_heads=x.n_heads,
                                 expand=x.lstm_expand,
                                 conv_width=x.ssm_conv_width),
         "slstm": jxl.init_slstm(key, x.d_model, n_heads=x.n_heads),
         "cross": jattn.init_attention(key, w.d_model, w.n_heads,
                                       w.n_kv_heads, w.hd, qkv_bias=True),
         "mlp": jmlp.init_mlp(key, w.d_model, w.d_ff)}
    rng = np.random.default_rng(0)
    return {k: _perturb(_np(jax.tree.map(np.asarray, v)), rng)
            for k, v in p.items()}


def _inputs():
    from repro_torch import configs
    rng = np.random.default_rng(1)
    out = {}
    for block in ARCHS:
        d = _cfg(configs, block).d_model
        out[block] = {
            "x": rng.standard_normal((B, S, d)).astype(np.float32),
            "c": rng.standard_normal((B, S, d)).astype(np.float32)}
    cfg = _cfg(configs, "cross")
    out["cross"]["mem"] = rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _splits(block, cfg):
    """{leaf: how a rank holds it}: None whole, ("dim", d) a contiguous
    half of dim d, ("blocked", d, parts) half of each part of dim d."""
    if block == "mamba2":
        d_in = cfg.ssm_heads * cfg.ssm_head_dim
        gn = cfg.ssm_groups * cfg.ssm_state
        conv = ("blocked", -1, (d_in, gn, gn))
        return {"in_proj.w": ("blocked", 1, (d_in, d_in, gn, gn,
                                             cfg.ssm_heads)),
                "conv_w": conv, "conv_b": conv, "A_log": ("dim", 0),
                "D": ("dim", 0), "dt_bias": ("dim", 0),
                "norm.scale": ("dim", 0), "out_proj.w": ("dim", 0)}
    if block == "mlstm":
        return {**{f"{k}.w": ("dim", 1) for k in ("up_x", "up_z", "wq", "wk",
                                                  "wv")},
                "conv_w": ("dim", 1), "conv_b": ("dim", 0),
                "w_i.w": None, "w_i.b": None, "w_f.w": None, "w_f.b": None,
                "norm.scale": ("dim", 0), "down.w": ("dim", 0)}
    if block == "slstm":
        return {"w_in.w": ("dim", 1), "w_in.b": None, "r": ("dim", 0),
                "norm.scale": None, "ff_gate.w": ("dim", 1),
                "ff_up.w": ("dim", 1), "ff_down.w": ("dim", 0)}
    if block == "cross":
        out = {f"{k}.w": ("dim", 1) for k in ("wq", "wk", "wv")}
        out.update({f"{k}.b": ("dim", 0) for k in ("wq", "wk", "wv")})
        return {**out, "wo.w": ("dim", 0)}
    return {"fc1.w": ("dim", 1), "fc1.b": ("dim", 0), "fc2.w": ("dim", 0),
            "fc2.b": None}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _half(a, dim, r):
    n = a.shape[dim] // WORLD
    return np.take(a, np.arange(r * n, (r + 1) * n), axis=dim)


def _local(tree, splits, r):
    """Rank r's leaves of a whole flat tree."""
    out = {}
    for path, a in _flat(tree).items():
        how = splits[path]
        if how is None:
            out[path] = a
        elif how[0] == "dim":
            out[path] = _half(a, how[1], r)
        else:
            dim, parts = how[1] % a.ndim, how[2]
            cuts = np.cumsum(parts)[:-1]
            out[path] = np.concatenate(
                [_half(p, dim, r) for p in np.split(a, cuts, axis=dim)],
                axis=dim)
    return out


def _rows(n, r):
    return slice(r * n // WORLD, (r + 1) * n // WORLD)


def _rank_main(rank, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.distributed import collectives, fsdp
    from repro_torch.kernels import dispatch
    from repro_torch.models import attention as attn
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models import ssm, xlstm
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        with open(os.path.join(out_dir, "params.pkl"), "rb") as f:
            params = pickle.load(f)
        inp = _inputs()
        group = dist.group.WORLD
        tp = fsdp.TPRule(group, WORLD, rank, True)
        rows = _rows(S, rank)
        fns = {"mamba2": ssm.mamba2_train, "mlstm": xlstm.mlstm_train,
               "slstm": xlstm.slstm_train}
        out = {}
        for block, a in inp.items():
            cfg = _cfg(configs, block)
            local = {k: torch.from_numpy(np.ascontiguousarray(v))
                     .requires_grad_(True) for k, v in _local(
                         params[block], _splits(block, cfg), rank).items()}
            p = _nest(local)
            x = torch.from_numpy(a["x"][:, rows]).requires_grad_(True)
            dispatch.reset_launch_counts()
            extra = {}
            if block in fns:
                y = collectives.scatter_sum(fns[block](
                    p, collectives.gather_sum(x, group, 1), cfg, tp),
                    group, 1)
            elif block == "cross":
                frames = _rows(cfg.encoder_seq, rank)
                mem = torch.from_numpy(a["mem"][:, frames]) \
                    .requires_grad_(True)
                extra["mem"] = mem
                mkv = attn.memory_kv(p, collectives.gather_sum(mem, group, 1),
                                     cfg)
                y = collectives.scatter_sum(attn.cross_attend(
                    p, collectives.gather_sum(x, group, 1), mkv, cfg, tp=tp),
                    group, 1)
            else:
                y = mlp_mod.mlp(p, x, act=cfg.act, tp=tp)
            (y * torch.from_numpy(a["c"][:, rows])).sum().backward()
            out[block] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                          "dp": {k: t.grad.numpy() for k, t in local.items()},
                          "routes": dispatch.route_counts()}
            if extra:
                out[block]["dmem"] = extra["mem"].grad.numpy()
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
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tprb")
    params = _params()
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    procs = mp.spawn(_rank_main, args=(_free_port(), str(tmp)),
                     nprocs=WORLD, join=False)
    return procs, tmp, params


@pytest.fixture(scope="module")
def jax_refs(setup):
    """The reference's whole blocks and their gradients."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import attention as jattn
    from repro.models import mlp as jmlp
    from repro.models import ssm as jssm
    from repro.models import xlstm as jxl
    _, _, params = setup
    inp = _inputs()
    fns = {"mamba2": jssm.mamba2_train, "mlstm": jxl.mlstm_train,
           "slstm": jxl.slstm_train}
    out = {}
    for block, a in inp.items():
        cfg = _cfg(configs, block)
        p = jax.tree.map(jnp.asarray, params[block])
        c = jnp.asarray(a["c"])
        if block in fns:
            y, vjp = jax.vjp(lambda p, x, f=fns[block], cfg=cfg: f(p, x, cfg),
                             p, jnp.asarray(a["x"]))
            dp, dx = vjp(c)
        elif block == "cross":
            def f(p, x, mem, cfg=cfg):
                return jattn.cross_attend(p, x, jattn.memory_kv(p, mem, cfg),
                                          cfg)
            y, vjp = jax.vjp(f, p, jnp.asarray(a["x"]), jnp.asarray(a["mem"]))
            dp, dx, dmem = vjp(c)
            out[block] = {"dmem": np.asarray(dmem)}
        else:
            y, vjp = jax.vjp(lambda p, x, cfg=cfg: jmlp.mlp(p, x, act=cfg.act),
                             p, jnp.asarray(a["x"]))
            dp, dx = vjp(c)
        out.setdefault(block, {}).update(
            y=np.asarray(y), dx=np.asarray(dx),
            dp=_np(jax.tree.map(np.asarray, dp)))
    return out


@pytest.fixture(scope="module")
def ranks(setup, jax_refs):
    procs, tmp, _ = setup
    while not procs.join():
        pass
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _close(got, want, what):
    """Within TOL of the array's scale: f32 sums of O(1) terms round apart
    between the two frameworks by a few ulps of the sum."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


# route -> calls of one block under tensor parallelism
ROUTES = {"mamba2": {"tp_ssm_heads": 1, "tp_feature_rows": 1},
          "mlstm": {"tp_lstm_heads": 1, "tp_feature_rows": 1},
          "slstm": {"tp_lstm_heads": 1, "tp_feature_rows": 1},
          "cross": {"tp_cross": 1}, "mlp": {}}
TP_ROUTES = ("tp_heads", "tp_kv_whole", "sp_rows", "tp_ssm_heads",
             "tp_lstm_heads", "tp_feature_rows", "tp_cross")


@pytest.mark.parametrize("block", list(ARCHS))
def test_block_matches_jax(ranks, jax_refs, block):
    from repro_torch import configs
    cfg = _cfg(configs, block)
    want = jax_refs[block]
    splits = _splits(block, cfg)
    for r, res in enumerate(ranks):
        got = res[block]
        _close(got["y"], want["y"][:, _rows(S, r)], f"{block} out")
        _close(got["dx"], want["dx"][:, _rows(S, r)], f"{block} dx")
        if "dmem" in want:
            _close(got["dmem"], want["dmem"][:, _rows(cfg.encoder_seq, r)],
                   f"{block} dmem")
        local = _local(want["dp"], splits, r)
        assert set(got["dp"]) == set(local)
        for path, w in local.items():
            # a whole leaf's gradient is summed over the ranks inside the
            # block, each rank's covering its own heads or columns
            _close(got["dp"][path], w, f"{block} d{path}")
        assert {k: got["routes"][k] for k in TP_ROUTES} == \
            {k: ROUTES[block].get(k, 0) for k in TP_ROUTES}
