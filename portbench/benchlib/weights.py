"""Weights from the seed, made on the device in a few large draws.

The matrices of a layout (``lib/layout.py``), in its order, are one
stream of standard normals cut into chunks of ``CHUNK`` values; chunk i
is drawn by a ``torch.Generator`` on the device seeded with a hash of
(seed, i), and each matrix takes its run of the stream times its spread.
Vectors are ones.  The same seed gives the same tensors, on the same kind
of device, so the reference can draw them again after the program's are
freed, and ``change_norms`` can compare the program's parameters with the
ones it started from without keeping a copy.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 27            # 512 MB of f32 at a time
_M64 = (1 << 64) - 1


def mix(*words: int) -> int:
    """splitmix64 over the words: a 63-bit seed for a generator."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h >> 1


def generator(device, *words: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(*words))
    return g


def _runs(lay: dict):
    """(path, offset in the stream, numel, std) of every matrix."""
    runs, off = [], 0
    for path, (shape, std) in lay.items():
        if std is None:
            continue
        n = math.prod(shape)
        runs.append((path, off, n, std))
        off += n
    return runs, off


def _chunks(seed: int, total: int, device):
    for c in range(-(-total // CHUNK)):
        n = min(CHUNK, total - c * CHUNK)
        gen = generator(device, seed, 1, c)
        yield c * CHUNK, torch.randn(n, generator=gen, device=device,
                                     dtype=torch.float32)


def _overlaps(runs, lo: int, size: int):
    """The runs overlapping the chunk [lo, lo + size): (path, first and
    last + 1 in the leaf, first and last + 1 in the chunk, std)."""
    hi = lo + size
    for path, off, n, std in runs:
        a, b = max(off, lo), min(off + n, hi)
        if a < b:
            yield path, a - off, b - off, a - lo, b - lo, std


def make(lay: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{path: tensor}: matrices in ``dtype`` drawn from the stream, vectors
    ones in f32."""
    runs, total = _runs(lay)
    out = {}
    for path, (shape, std) in lay.items():
        if std is None:
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[path] = torch.empty(shape, dtype=dtype, device=device)
    with torch.no_grad():
        for lo, buf in _chunks(seed, total, device):
            for path, a, b, ca, cb, std in _overlaps(runs, lo, buf.numel()):
                out[path].view(-1)[a:b].copy_(buf[ca:cb].mul_(std))
    return dict((p, out[p]) for p in lay)


def change_norms(lay: dict, seed: int, flat: dict) -> dict:
    """{path: L2 norm of flat[path] less the tensor ``make`` drew for it}
    (f64 sums), drawing the stream again chunk by chunk on the tensors'
    device."""
    runs, total = _runs(lay)
    device = next(iter(flat.values())).device
    sq = {p: 0.0 for p in lay}
    with torch.no_grad():
        for path, (shape, std) in lay.items():
            if std is None:
                sq[path] = float((flat[path].double() - 1.0).square().sum())
        for lo, buf in _chunks(seed, total, device):
            for path, a, b, ca, cb, std in _overlaps(runs, lo, buf.numel()):
                leaf = flat[path].detach().reshape(-1)
                have = leaf[a:b].double()
                want = buf[ca:cb].mul(std).to(leaf.dtype).double()
                sq[path] += float((have - want).square().sum())
    return {p: math.sqrt(v) for p, v in sq.items()}
