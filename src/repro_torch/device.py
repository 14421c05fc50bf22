"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the card.  Without a
CUDA device that raises and tells the caller to ask for the CPU: the port
never drops to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
    return dev
