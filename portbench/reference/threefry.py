"""``jax.random``'s threefry2x32 (the partitionable counter layout) as far
as the served tokens' draws need it: keys, ``fold_in`` and the Gumbel
noise of a categorical draw, in plain int64 and float32 torch.  The
served model samples token t of request r as the argmax of its logits
plus gumbel(fold_in(fold_in(key(seed), r), t)); the reference draws the
same noise to judge the token.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round hash of counter words (x0, x1) under key words (k0,
    k1): int64 tensors of uint32 values that broadcast together."""
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    z = torch.zeros((), dtype=torch.int64, device=k.device)
    d = torch.tensor(int(data) & M32, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], z, d)
    return torch.stack([y0, y1])


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """gumbel(k, (n,)) in float32: -log(-log(u)), u uniform on [tiny, 1)
    from the 23 high bits of each counter's hash."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], idx >> 32, idx & M32)
    w = y0 ^ y1
    bits = (((w >> 9) & 0x7FFFFF) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    tiny = float(np.finfo(np.float32).tiny)
    lo = torch.tensor(np.float32(tiny), device=k.device)
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo.cpu())
    u = torch.maximum(lo, (floats.double() * span + float(lo)).float())
    return -torch.log(-torch.log(u))


def token_noise(seed: int, rid: int, pos: int, n: int, device) -> torch.Tensor:
    """The noise of request ``rid``'s token at logical position ``pos``."""
    return gumbel(fold_in(fold_in(key(seed, device), rid), pos), n)
