"""Gated (SwiGLU) feed-forward block, as ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def gated_mlp_shapes(d_model: int, d_ff: int) -> dict:
    return {"gate": {"w": (d_model, d_ff)}, "up": {"w": (d_model, d_ff)},
            "down": {"w": (d_ff, d_model)}}


def gated_mlp(p: dict, x: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    if act not in cm.ACTIVATIONS:
        raise NotImplementedError(
            f"activation {act!r} is not ported yet (see ROADMAP.md, "
            "queue 1, slice 5: the other block kinds)")
    f = cm.ACTIVATIONS[act]
    return cm.linear(p["down"],
                     f(cm.linear(p["gate"], x)) * cm.linear(p["up"], x))
