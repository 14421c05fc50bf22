"""Common building blocks: linears, embeddings, norms, rotary embeddings.

Counterpart of ``repro/models/common.py``.  Parameters are plain nested
dicts of tensors (the JAX pytree layout); every op is a function on
tensors.  Matrix products stay ``torch.matmul`` (XLA's job in the JAX
package); RMSNorm goes through the kernel dispatch.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch

Params = dict


def linear_std(d_in: int) -> float:
    """Default stddev of ``init_linear`` weights."""
    return 1.0 / math.sqrt(d_in)


def linear(p: Params, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    w = p["w"].to(dtype) if dtype is not None else p["w"]
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids.long()]


def vocab_rows(p: Params, ids: torch.Tensor, *, start: int
               ) -> torch.Tensor:
    """The rows of the ids this rank owns, zeros for the others:
    ``p["table"]`` holds vocab rows [start, start + V / tp) of the
    table."""
    table = p["table"]
    local = ids.long() - start
    own = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(own[..., None], rows, torch.zeros_like(rows))


def embed_vocab_parallel(p: Params, ids: torch.Tensor, *, start: int,
                         group, dtype) -> torch.Tensor:
    """The vocab-parallel embedding under tensor and sequence parallelism:
    ``p["table"]`` holds vocab rows [start, start + V / tp) of the table;
    ids (B, S) the whole sequence.  Each rank looks its rows up, zeros the
    ids it does not own (``vocab_rows``), casts to ``dtype`` and
    reduce-scatters the (B, S, d) partials along the sequence
    (``collectives.scatter_sum``): -> this rank's rows (B, S / tp, d).
    Each id has one owner, so the sum adds exact zeros to it."""
    part = vocab_rows(p, ids, start=start)
    return collectives.scatter_sum(part.to(dtype), group, 1)


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Through the dispatch: the CUDA kernel on the card, the plain version
    on the CPU."""
    return dispatch.rmsnorm(x, p["scale"], eps=eps)


def layernorm(p: Params, x: torch.Tensor, *,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def apply_norm(kind: str, p: Params, x: torch.Tensor, *,
               rms_eps: float = 1e-6) -> torch.Tensor:
    """The block's norm; ``rms_eps`` is RMSNorm's epsilon (the config's
    ``rms_norm_eps``), a layernorm keeps its own."""
    if kind == "rmsnorm":
        return rmsnorm(p, x, eps=rms_eps)
    if kind == "layernorm":
        return layernorm(p, x)
    raise ValueError(f"unknown norm {kind}")


def norm_rows(kind: str, p: Params, x: torch.Tensor, tp=None, *,
              rms_eps: float = 1e-6) -> torch.Tensor:
    """A norm of the residual; under tensor and sequence parallelism
    (``tp``, ``fsdp.TPRule``) on this rank's sequence rows (the
    ``sp_rows`` route), its whole leaves' gradients summed over the model
    group, since each rank's covers its own rows."""
    if tp is not None:
        dispatch.count_route("sp_rows")
        p = {k: collectives.sum_grads(t, tp.group) for k, t in p.items()}
    return apply_norm(kind, p, x, rms_eps=rms_eps)


def on_sequence(fn, x: torch.Tensor, tp=None) -> torch.Tensor:
    """fn over the whole sequence (dim 1).  Under tensor and sequence
    parallelism x is this rank's rows: gathered along the sequence before
    fn (``gather_sum``: the backward sums the ranks' partial cotangents),
    and fn's partial sums (a row-parallel product's) reduce-scattered back
    to the rows (``scatter_sum``)."""
    if tp is None:
        return fn(x)
    x = collectives.gather_sum(x, tp.group, 1)
    return collectives.scatter_sum(fn(x), tp.group, 1)


def rmsnorm_features(p: Params, y: torch.Tensor, tp=None, *,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over a feature dim that tensor parallelism splits (mamba2's
    gated norm, the mLSTM's): under ``tp`` y holds this rank's d / tp
    columns and ``p["scale"]`` its slice of the scale.  The rows are
    all-gathered along the features (``gather_sum``: the backward sums the
    ranks' partial cotangents), kernel 1 runs on whole rows with the scale
    gathered (``gather_slice``: the scale's gradient is this rank's
    slice, the only columns its cotangent reaches), and this rank's
    columns are taken back (the ``tp_feature_rows`` route)."""
    if tp is None:
        return rmsnorm(p, y, eps=eps)
    dispatch.count_route("tp_feature_rows")
    n = y.shape[-1]
    whole = collectives.gather_sum(y, tp.group, y.dim() - 1)
    scale = collectives.gather_slice(p["scale"], tp.group, 0)
    return rmsnorm({"scale": scale}, whole, eps=eps).narrow(-1, tp.rank * n,
                                                            n)


def norm_shapes(kind: str, d: int) -> dict:
    if kind == "rmsnorm":
        return {"scale": (d,)}
    if kind == "layernorm":
        return {"scale": (d,), "bias": (d,)}
    raise ValueError(f"unknown norm {kind}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> cos, sin of shape (..., head_dim // 2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]):
    """Multimodal RoPE (Qwen2-VL).  positions (3, B, S) int: temporal,
    height and width position ids; ``sections`` the half-dims each axis
    owns, in order (sum = head_dim / 2).  Frequency slot j takes its angle
    from the axis ``sections`` assigns it, picked exactly (the JAX package
    mixes the axes with a one-hot einsum, whose products by 0 and 1 are
    exact too).  Returns cos, sin of shape (B, S, head_dim // 2)."""
    if positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions are (3, B, S), got "
                         f"{tuple(positions.shape)}")
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv                # (3, B, S, D/2)
    axis = torch.cat([torch.full((n,), i, dtype=torch.int64,
                                 device=positions.device)
                      for i, n in enumerate(sections)])     # (D/2,)
    mixed = ang.gather(0, axis.expand(1, *ang.shape[1:]))[0]
    return torch.cos(mixed), torch.sin(mixed)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D'/2) broadcast over heads.
    ``rotary_dim`` < D rotates only the first rotary_dim features
    (StableLM-2's partial rotary)."""
    d = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else d
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    cos = cos[..., None, : rd // 2]
    sin = sin[..., None, : rd // 2]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < d:
        y = torch.cat([y, xp.to(y.dtype)], dim=-1)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, ``jax.nn.gelu(x, approximate=True)``, in its order
    of operations: x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 x^3))))."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x ** 3)))
    return x * cdf


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu": relu}
