"""Weight bridge from the JAX package's parameter layout.

``params_from_jax`` takes the tree ``repro.models.model.init_params``
returns, with its leaves already turned into numpy arrays by the caller
(the port never imports jax), and builds the port's parameters;
``opt_state_from_jax`` does the same for an optimizer state such as
shared RMSProp's {"g": tree}, whose trees have the parameters' layout.
``agent_params_from_jax`` and ``agent_opt_state_from_jax`` do it for the
RL agents of ``repro.models.atari`` (nested dicts, conv weights HWIO, the
layout the port keeps).  The JAX
tree stacks the layers for ``lax.scan`` when the block cycle tiles the
depth: ``params["layers"]`` is then a tuple with one entry per position in
the cycle, each leaf carrying a leading ``n_cycles`` dimension
(repro/models/model.py:257-261).  Layer i is entry ``i % cycle`` at index
``i // cycle``, for every leaf of every block kind in the cycle (xlstm's
seven mLSTM blocks and one sLSTM block each have their own dict).  Other
stacks (zamba2's, whose shared block forbids the scan) are a plain list of
layers; an encoder-decoder keeps its ``enc_layers`` and ``dec_layers``
lists.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed.sharding import scan_stacked as _use_scan
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def params_from_jax(cfg: ModelConfig, tree: Any, device=None,
                    dtype: torch.dtype = torch.float32) -> M.Params:
    """JAX parameter tree (numpy leaves) -> the port's parameters on
    ``device``.  Matrices are stored in ``dtype``, vectors stay f32 (the
    split ``cast_params`` makes)."""
    dev = resolve(device)
    tree = _unstack(cfg, tree)

    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=dtype if t.dim() >= 2 else
                    torch.float32)
    params = M.tree_map(leaf, tree)
    want = M.param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in M.flatten(params).items()}
    if got != want:
        raise ValueError(f"{cfg.name}: bridged parameters do not match the "
                         f"port's layout: {sorted(set(got) ^ set(want))} "
                         "differ in name, or shapes differ")
    return params


def opt_state_from_jax(cfg: ModelConfig, state: Any, device=None) -> dict:
    """JAX optimizer state {name: parameter-shaped tree} (numpy leaves),
    e.g. shared RMSProp's {"g": tree} -> the same in the port's layout on
    ``device``, every leaf f32."""
    return {name: params_from_jax(cfg, tree, device, torch.float32)
            for name, tree in state.items()}


def _unstack(cfg: ModelConfig, tree: Any) -> Any:
    """The tree with its layers as a plain list, one entry per layer (an
    encoder-decoder's ``enc_layers`` and ``dec_layers`` are lists
    already; zamba2's ``shared_attn`` is one block beside its list)."""
    if cfg.is_encdec:
        return dict(tree)
    layers = tree["layers"]
    if _use_scan(cfg):
        cyc = len(cfg.block_cycle)
        layers = [M.tree_map(lambda a, i=i: np.asarray(a)[i // cyc],
                             layers[i % cyc]) for i in range(cfg.n_layers)]
    elif len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree, "
                         f"config has {cfg.n_layers}")
    return dict(tree, layers=list(layers))


def agent_params_from_jax(tree: Any, device=None) -> dict:
    """A JAX agent's parameters (``init_atari_params`` or
    ``init_mlp_agent_params``, numpy leaves) -> the port's, f32 on
    ``device``.  Both keep conv weights HWIO and linear weights
    (d_in, d_out), so no leaf is permuted."""
    dev = resolve(device)
    return M.tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32, copy=True)).to(dev), dict(tree))


def agent_opt_state_from_jax(state: Any, device=None, *,
                             n_workers: int = 0):
    """A JAX optimizer state of an agent ({"g": tree} or {"m": tree}) -> the
    port's.  ``n_workers`` > 0 takes the runner's per-worker statistics,
    stacked on a leading worker axis by its vmap, and returns one state a
    worker, as the port's runner keeps them."""
    if n_workers:
        return [agent_opt_state_from_jax(M.tree_map(
            lambda a, i=i: np.asarray(a)[i], dict(state)), device)
            for i in range(n_workers)]
    return {name: agent_params_from_jax(tree, device)
            for name, tree in state.items()}
