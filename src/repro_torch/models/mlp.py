"""Feed-forward blocks, as ``repro/models/mlp.py``: the gated (SwiGLU)
MLP and the plain two-layer MLP with biases (Whisper's)."""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.models import common as cm


def gated_mlp_shapes(d_model: int, d_ff: int) -> dict:
    return {"gate": {"w": (d_model, d_ff)}, "up": {"w": (d_model, d_ff)},
            "down": {"w": (d_ff, d_model)}}


def gated_mlp(p: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """The SwiGLU MLP.  On this rank's d_ff columns of ``gate``/``up`` and
    rows of ``down`` (tensor parallelism) it returns this rank's partial
    sum of the output, which the caller reduce-scatters."""
    f = cm.ACTIVATIONS[act]
    return cm.linear(p["down"],
                     f(cm.linear(p["gate"], x)) * cm.linear(p["up"], x))


def mlp_shapes(d_model: int, d_ff: int, *, bias: bool = True) -> dict:
    """``init_mlp``'s layout: fc1 (d_model, d_ff) and fc2 (d_ff, d_model),
    each with a bias by default."""
    def lin(d_in, d_out):
        p = {"w": (d_in, d_out)}
        if bias:
            p["b"] = (d_out,)
        return p
    return {"fc1": lin(d_model, d_ff), "fc2": lin(d_ff, d_model)}


def mlp(p: dict, x: torch.Tensor, *, act: str = "gelu",
        tp=None) -> torch.Tensor:
    """The plain MLP.  Under tensor and sequence parallelism (``tp``) x is
    this rank's sequence rows: gathered along the sequence, ``fc1`` on
    this rank's d_ff columns (its bias with them), ``fc2`` on its rows,
    the partial sums reduce-scattered back to the rows, and ``fc2``'s
    whole bias added once after that (its gradient summed over the model
    group: each rank's covers its own rows)."""
    f = cm.ACTIVATIONS[act]
    if tp is None:
        return cm.linear(p["fc2"], f(cm.linear(p["fc1"], x)))
    y = cm.on_sequence(lambda h: f(cm.linear(p["fc1"], h)) @ p["fc2"]["w"],
                       x, tp)
    if "b" in p["fc2"]:
        y = y + collectives.sum_grads(p["fc2"]["b"], tp.group).to(y.dtype)
    return y
