"""``jax.random``'s default generator (threefry2x32) in torch.

The JAX package draws every random number of the LLM path from
``jax.random``: sampled tokens, training batches, initial weights.  This
module computes the same numbers, so the port's ``--seed`` gives the
reference's tokens, batches and weights.

A key is an int64 tensor of shape (..., 2) holding the two uint32 words of
``jax.random.key_data``, and ``bits`` returns uint32 values the same way;
the hash itself runs on int32 bit patterns.  Everything is plain
elementwise torch and runs on the device of the key tensor; on the card
a small draw's hash (the RL loop's per-step splits and draws) replays a
CUDA graph of those ops.

The counter layout of ``split`` and ``bits`` depends on jax's
``jax_threefry_partitionable`` flag (True from jax 0.5 on, False before).
Both layouts are here, chosen by the ``partitionable`` argument, which
defaults to True; nothing reads a jax flag.

  - partitionable: element i of a draw hashes the 64-bit counter i split
    into (hi, lo) words and is the xor of the two output words; ``split``
    hashes (0, i), as ``fold_in`` does;
  - original: the n counters 0..n-1 (padded to even) are cut in two
    halves that are hashed pairwise, element i < n/2 taking the first
    output word of pair i and element n/2 + i the second.

Floating-point draws follow ``jax._src.random`` operation for operation in
f32, with the fused multiply-adds and the erfinv polynomial of XLA's CPU
code, so ``uniform`` and ``bernoulli`` are exact.  torch's ``log`` and
``log1p`` round differently from XLA's in the last place on some inputs,
so ``gumbel`` differs from jax's by about 1e-6 at most (``categorical``
agrees wherever its top-2 margin is larger) and ``truncated_normal`` by a
few ulps on about 1 % of its values.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# flat elements hashed at a time: bounds the temporaries of a large draw
# (an embedding of 262 M elements) to a few hundred MB
CHUNK = 1 << 24
# draws of at most this many elements run on one CPU thread (see _serial)
SERIAL_MAX = 1 << 20
# hashes of at most this many elements run on the card as a CUDA graph
# (see _hash)
GRAPH_MAX = 1 << 16
_F32 = torch.float32

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


@contextlib.contextmanager
def _serial(t: torch.Tensor, numel: int):
    """One intra-op thread for a draw of ``numel`` elements on the CPU up
    to SERIAL_MAX: a draw is a few hundred elementwise ops, too small each
    to gain from threads, and with several processes sharing the cores
    (test workers) OpenMP's barriers made each op cost milliseconds.
    Larger draws, and draws on the card, are left as they are."""
    n = torch.get_num_threads()
    if t.device.type != "cpu" or numel > SERIAL_MAX or n == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class MarginLog:
    """The decision margins of the discrete draws made while it is open
    (``margins()``): for each ``categorical`` the smallest top-2 gap of
    noise plus logits, for each ``choice`` without replacement the gap
    between the last chosen and the first unchosen score, and whatever a
    caller adds with ``record_margin`` (the runners' greedy actions).  A
    draw repeats on another device or framework wherever its margin is
    far above the ~1e-6 by which the Gumbel noise differs (module
    docstring), so identity checks are qualified by ``smallest``."""

    def __init__(self):
        self.gaps = []

    def add(self, gap: torch.Tensor) -> None:
        if gap.numel():
            self.gaps.append(gap.detach().float().min().reshape(1))

    def smallest(self) -> float:
        if not self.gaps:
            return math.inf
        return float(torch.cat([g.cpu() for g in self.gaps]).min())


_LOG = []


@contextlib.contextmanager
def margins():
    """Collect the margins of the draws inside the block into a
    ``MarginLog`` (nothing is collected, and nothing costs, outside)."""
    log = MarginLog()
    _LOG.append(log)
    try:
        yield log
    finally:
        _LOG.remove(log)


def logging_margins() -> bool:
    """True inside a ``margins()`` block."""
    return bool(_LOG)


def record_margin(gap: torch.Tensor) -> None:
    for log in _LOG:
        log.add(gap)


def _i32(t: torch.Tensor) -> torch.Tensor:
    """The int32 bit pattern of uint32 values held in int64."""
    return (t & M32).to(torch.int32)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """The uint32 values, in int64, of an int32 bit pattern."""
    return t.to(torch.int64) & M32


def _hash(k0, k1, x0, x1):
    """Threefry-2x32 on int32 bit patterns that broadcast together.  A
    small draw on the card replays a CUDA graph of ``_hash_ops`` captured
    once for its shapes: the ~140 elementwise kernels of a hash become one
    launch, where each would cost the host more than the card (the RL
    loop splits and draws a few keys a worker every step)."""
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    if x0.is_cuda and math.prod(shape) <= GRAPH_MAX:
        return _graphed_hash(k0, k1, x0, x1)
    return _hash_ops(k0, k1, x0, x1)


_GRAPHS = {}


def _graphed_hash(*inputs):
    """``_hash_ops`` by replaying the CUDA graph captured for these input
    shapes on this device (captured at the first call, after one eager
    warm-up on a side stream):
    the inputs are copied into the graph's own buffers, and the outputs
    copied out of them, since the next replay overwrites them."""
    sig = (inputs[0].device,) + tuple(tuple(t.shape) for t in inputs)
    entry = _GRAPHS.get(sig)
    if entry is None:
        static = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in inputs]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        side = torch.cuda.Stream(device=static[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _hash_ops(*static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = _hash_ops(*static)
        entry = _GRAPHS[sig] = (graph, static, outs)
    graph, static, outs = entry
    for dst, src in zip(static, inputs):
        dst.copy_(src)
    graph.replay()
    return outs[0].clone(), outs[1].clone()


def _hash_ops(k0, k1, x0, x1):
    """Threefry-2x32 on int32 bit patterns that broadcast together: adds
    wrap at 2^32 and the right shift of each rotation is masked to a
    logical one.  Half the bytes and fewer operations than int64 words,
    which a large draw's time is made of."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    # fresh tensors of the full shape: the rounds below work in place
    x0 = (x0 + ks[0]).expand(shape).contiguous()
    x1 = (x1 + ks[1]).expand(shape).contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            high = x1 << r
            x1 >>= 32 - r
            x1 &= (1 << r) - 1
            x1 |= high
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words (x0, x1) under key
    words (k0, k1), int64 tensors of uint32 values that broadcast
    together.  Returns the two output words, the same way."""
    y0, y1 = _hash(_i32(k0), _i32(k1), _i32(x0), _i32(x1))
    return _u32(y0), _u32(y1)


def key(seed: int, device=None) -> torch.Tensor:
    """The raw words of ``jax.random.key(seed)``: (0, seed mod 2^32), as
    jax makes them with 64-bit types disabled (its default)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast over ``ndim`` trailing
    dimensions of counters."""
    tail = (1,) * ndim
    return (key[..., 0].reshape(*key.shape[:-1], *tail),
            key[..., 1].reshape(*key.shape[:-1], *tail))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter (0, data mod 2^32).  ``key``
    (..., 2) and ``data`` (an int or an integer tensor) broadcast; the
    result is (broadcast shape, 2)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2, *,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split`` of a key (2,) into (num, 2), or of a batch of
    keys (..., 2) into (..., num, 2), as ``vmap(split)`` does."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    if partitionable:
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
        return torch.stack([y0, y1], dim=-1)
    y0, y1 = threefry2x32(k0, k1, i, i + num)
    return torch.cat([y0, y1], dim=-1).reshape(*key.shape[:-1], num, 2)


def _bits32_at(key: torch.Tensor, idx: torch.Tensor, size: int,
               partitionable: bool) -> torch.Tensor:
    """The 32-bit words, as int32 bit patterns, at flat positions ``idx``
    (int64) of a draw of ``size`` elements under ``key`` (..., 2): shape
    (key batch, *idx.shape)."""
    k0, k1 = (_i32(w) for w in _words(key, idx.dim()))
    if partitionable:
        with _serial(idx, key[..., 0].numel() * idx.numel()):
            y0, y1 = _hash(k0, k1, _i32(idx >> 32), _i32(idx))
            return y0.bitwise_xor_(y1)
    if size >= M32:
        raise NotImplementedError("draws of 2^32 - 1 elements or more in "
                                  "the original threefry layout")
    half = (size + 1) // 2
    first = idx < half
    x0 = torch.where(first, idx, idx - half)
    x1 = x0 + half
    x1 = torch.where(x1 < size, x1, torch.zeros_like(x1))
    with _serial(idx, key[..., 0].numel() * idx.numel()):
        y0, y1 = _hash(k0, k1, _i32(x0), _i32(x1))
    return torch.where(first, y0, y1)


def _bits32(key: torch.Tensor, shape: tuple,
            partitionable: bool) -> torch.Tensor:
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    return _bits32_at(key, idx, size, partitionable).reshape(
        tuple(key.shape[:-1]) + shape)


def bits(key: torch.Tensor, shape: Shape, *,
         partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bits`` (uint32) as int64: (key batch, *shape)."""
    return _u32(_bits32(key, _shape(shape), partitionable))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(float(np.float32(x)), dtype=_F32)


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    """The mantissa trick of ``jax._src.random._uniform`` on int32 bit
    patterns: the 23 high random bits under the exponent of 1.0, minus 1,
    a float in [0, 1)."""
    w = ((words >> 9) & 0x7FFFFF) | 0x3F800000
    return w.view(_F32) - 1.0


def _affine(floats: torch.Tensor, minval: float, maxval: float):
    """max(minval, floats * (maxval - minval) + minval) in f32, the
    product and sum rounded once, as XLA's fused multiply-add on the CPU
    computes it: in f64 the product of two f32 values is exact, and so is
    the sum for the operands drawn here."""
    lo, hi = _f32(minval), _f32(maxval)
    span = float(hi - lo)
    y = (floats.double() * span + float(lo)).float()
    return torch.maximum(lo.to(floats.device), y)


# XLA's single-precision erfinv (M. Giles, "Approximating the erfinv
# function"), its two branches' polynomial coefficients, highest first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 erfinv as XLA computes it, each Horner step a fused
    multiply-add as XLA's CPU code makes it (``torch.erfinv`` lands
    several ulps from it; this lands within the last-place differences of
    ``log1p``)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i]).to(x.device),
                           _f32(_ERFINV_GE5[i]).to(x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    edge = x * float(np.finfo(np.float32).max)
    return torch.where(x.abs() == 1.0, edge, p * x)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, *, partitionable: bool = True
            ) -> torch.Tensor:
    """``jax.random.uniform`` in f32: (key batch, *shape)."""
    return _affine(_unit_floats(_bits32(key, _shape(shape), partitionable)),
                   minval, maxval)


def bernoulli(key: torch.Tensor, p: float, shape: Shape, *,
              partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for an f32 ``p``: bool."""
    u = uniform(key, shape, partitionable=partitionable)
    return u < _f32(p).to(u.device)


def randint(key: torch.Tensor, shape: Shape, minval, maxval, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds (jax's default int): two
    words a value from the keys of ``split(key)``, reduced into the span
    as jax does.  int64 values in [minval, maxval): (key batch, *shape).
    The bounds are ints, or integer tensors that broadcast against the
    result (one bound a key: shape (K, 1, ...) for keys (K, 2)), as
    ``vmap(randint)`` over traced bounds."""
    for v in (minval, maxval):
        if isinstance(v, int) and not -2**31 <= v < 2**31:
            raise ValueError(f"randint bound {v} is not an int32")
    lo = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi_b = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    k = split(key, 2, partitionable=partitionable)
    hi = bits(k[..., 0, :], shape, partitionable=partitionable)
    lo_bits = bits(k[..., 1, :], shape, partitionable=partitionable)
    span = torch.where(hi_b > lo, (hi_b - lo) & M32, torch.ones_like(hi_b))
    # uint32 arithmetic: the squares, the product and the sum wrap at 2^32
    mult = ((((1 << 16) % span) ** 2) & M32) % span
    off = ((hi % span) * mult) & M32
    off = ((off + lo_bits % span) & M32) % span
    return off + lo


def gumbel(key: torch.Tensor, shape: Shape, *,
           partitionable: bool = True) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, mode "low":
    -log(-log(uniform(tiny, 1)))."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, tiny, 1.0, partitionable=partitionable)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, *,
                partitionable: bool = True) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of Gumbel
    noise plus f32 logits.  ``key`` (2,) draws noise of the logits' shape;
    a batch of keys (B, 2) draws one row of noise per key for logits
    (B, V), as ``vmap(categorical)`` does.  A small draw on the CPU runs
    on one thread throughout, the noise's floats and the argmax too
    (``_serial``)."""
    logits = logits.float()
    shape = logits.shape if key.dim() == 1 else logits.shape[key.dim() - 1:]
    with _serial(logits, logits.numel()):
        scores = gumbel(key, shape, partitionable=partitionable) + logits
        if _LOG and scores.shape[-1] > 1:
            top = torch.topk(scores, 2, dim=-1).values
            record_margin(top[..., 0] - top[..., 1])
        return torch.argmax(scores, dim=-1)


def normal(key: torch.Tensor, shape: Shape, *,
           partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal`` in f32 (``_normal_real``): sqrt(2) *
    erfinv(uniform(nextafter(-1, 0), 1)), (key batch, *shape).  Within the
    few ulps of ``erfinv``."""
    u = uniform(key, shape, float(_nextafter(-1.0, 0.0)), 1.0,
                partitionable=partitionable)
    return _f32(math.sqrt(2.0)).to(u.device) * erfinv(u)


def choice(key: torch.Tensor, n: int, shape: Shape, *, replace: bool = True,
           p: torch.Tensor, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace, p)`` with probabilities
    ``p`` (n,) (f32), the two arms of jax's: with replacement, the
    searchsorted (side left) of cumsum(p)[-1] * (1 - uniform) in cumsum(p);
    without, the top ``prod(shape)`` of gumbel(key, (n,)) + log p (lax's
    top_k: ties go to the lower index, and log 0 = -inf sorts last).
    A batch of keys (K, 2) with ``p`` (K, n) draws one row per key, as
    ``vmap(choice)``.  int64 indices, (key batch, *shape)."""
    shape = _shape(shape)
    p = p.float()
    batch = key.shape[:-1]
    if replace:
        cum = torch.cumsum(p, dim=-1)
        u = uniform(key, shape, partitionable=partitionable)
        r = cum[..., -1:] * (1.0 - u.reshape(*batch, -1))
        return torch.searchsorted(cum.expand(*batch, n).contiguous(),
                                  r.contiguous()).reshape(tuple(batch)
                                                          + shape)
    k = math.prod(shape)
    g = gumbel(key, (n,), partitionable=partitionable) + torch.log(p)
    srt = torch.sort(g, dim=-1, descending=True, stable=True)
    if _LOG and k < n:
        record_margin(srt.values[..., k - 1] - srt.values[..., k])
    return srt.indices[..., :k].reshape(tuple(batch) + shape)


def _nextafter(x: float, toward: float) -> torch.Tensor:
    return torch.nextafter(_f32(x), _f32(toward))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape, *, partitionable: bool = True,
                     scale: float = 1.0, dtype: torch.dtype = _F32
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in f32:
    sqrt(2) * erfinv(uniform(erf(lower / sqrt 2), erf(upper / sqrt 2))),
    clamped into the open interval.  With ``scale`` the f32 draw is
    multiplied by f32(scale), as ``stddev * truncated_normal(...)``; the
    result is stored in ``dtype``.  One key (2,) only; drawn CHUNK flat
    elements at a time, so the temporaries stay small whatever the
    shape."""
    shape = _shape(shape)
    size = math.prod(shape)
    dev = key.device
    sqrt2 = _f32(math.sqrt(2.0))
    a = torch.erf(_f32(lower) / sqrt2)
    b = torch.erf(_f32(upper) / sqrt2)
    lo = _nextafter(lower, math.inf).to(dev)
    hi = _nextafter(upper, -math.inf).to(dev)
    sqrt2, scale_t = sqrt2.to(dev), _f32(scale).to(dev)
    out = torch.empty(size, dtype=dtype, device=dev)
    for start in range(0, size, CHUNK):
        idx = torch.arange(start, min(size, start + CHUNK),
                           dtype=torch.int64, device=dev)
        with _serial(idx, idx.numel()):
            u = _affine(_unit_floats(_bits32_at(key, idx, size,
                                                partitionable)),
                        float(a), float(b))
            z = torch.clamp(sqrt2 * erfinv(u), lo, hi)
            out[start:start + idx.numel()] = (z if scale == 1.0
                                              else z * scale_t)
    return out.reshape(shape)
