"""Thread-local sharding rules and mesh, as ``repro/distributed/ctx.py``.

The active rule set (``current_rules``) and the context manager that
installs one (``sharding_rules``): the model layer reads the rules when it
lays out and writes a KV cache and when it picks the expert-parallel MoE
(``moe_ep``); the dispatch layer reads them to pick the context-parallel
decode.  The installed mesh (``use_mesh``, ``current_mesh``): the train
step reads it for its data and model groups.  The JAX module also folds
rules and mesh into a trace token, because a jitted function would
otherwise replay a trace made under others; eager PyTorch keeps no trace
cache, so the port needs no token.

``constrain`` is the identity.  The reference names its activation
layouts there ("residual", "attn_q", "attn_kv") and GSPMD places the
collectives that realise them; the port expresses the same layouts as
explicit collectives in the model layer instead.  Under tensor and
sequence parallelism (``fsdp.tp_rule``) the residual stream between
blocks is each rank's slice of the sequence (``residual``), gathered
before each column-parallel product and reduce-scattered after each
row-parallel one, and attention runs on each rank's local heads
(``attn_q``/``attn_kv``); ``sharding.activation_rules`` gives the entries
as spec tuples.  Without it every activation is held whole on each rank of
the model axis.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_state = threading.local()


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[dict]):
    """Install ``rules`` (e.g. ``sharding.decode_rules(...)``; None clears
    them) for the body of the ``with``."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The named activation constraint: the identity (the model layer lays
    the activations out itself; see the module docstring)."""
    return x


def current_mesh():
    """The mesh the launcher installed (None on a single-process run)."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``; None clears it) for the body of
    the ``with``."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_devices(mesh) -> int:
    """Ranks in a mesh (a ``DeviceMesh`` or an {axis: size} dict)."""
    sizes = mesh.values() if isinstance(mesh, dict) else mesh.shape
    n = 1
    for s in sizes:
        n *= s
    return n
