"""The actor/serving side of ``repro/core/llm_a3c.py``: per-slot sampling,
the one-token serve step and the chunked-prefill step.

Sampling keys.  The JAX package draws row j's token from the threefry
stream ``fold_in(fold_in(key, sid), pos)``, which torch cannot reproduce,
so cross-framework parity is greedy only.  The port keeps the invariant
that matters: each draw depends only on (seed, stream id, absolute
position), never on the row's slot, the batch size or the step count.  It
samples by Gumbel-max, with the noise of vocabulary entry v taken from a
counter hash of (seed, sid, pos, v) computed in integer torch ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finaliser on int64 tensors holding values < 2^32.
    The multipliers are odd and below 2^31, so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, sids: torch.Tensor, pos: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) f32 Gumbel(0, 1) noise; row j depends only on
    (seed, sids[j], pos[j])."""
    dev = sids.device
    h = _mix(torch.full_like(sids, int(seed) & _M32))
    h = _mix(h ^ (sids & _M32))
    h = _mix(h ^ (pos & _M32))                                     # (B,)
    v = torch.arange(vocab, device=dev, dtype=torch.int64)
    u = _mix(h[:, None] ^ ((v * 0x61C88647) & _M32)[None, :])      # (B, V)
    # 24 high bits -> uniform in (0, 1), never 0 or 1 in f32
    unif = ((u >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(unif))


def sample_slot_tokens(logits: torch.Tensor, seed: int = 0, *,
                       sample: bool = True,
                       sids: Optional[torch.Tensor] = None,
                       pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling: logits (B, V) -> tokens (B,) int64.

    With ``sids``/``pos`` (the serve engine's path) row j draws from the
    (seed, sids[j], pos[j]) stream, pos being the logical position of the
    sampled token.  Without them row j uses stream id j at position 0 and
    the caller folds its step index into ``seed``."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    b, vocab = logits.shape
    dev = logits.device
    if sids is None:
        sids = torch.arange(b, device=dev)
        pos = torch.zeros(b, dtype=torch.int64, device=dev)
    sids = torch.as_tensor(sids, device=dev).to(torch.int64).expand(b)
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(b)
    noise = gumbel_noise(seed, sids, pos, vocab)
    return torch.argmax(logits.float() + noise, dim=-1)


def make_serve_step(cfg: ModelConfig, *, sample: bool = True):
    """One-token decode step for the serving path.

    ``serve_step(params, cache, batch, pos, seed, sids=None, finite=None)
    -> (token (B,), value (B,), cache)``; ``pos`` a lockstep scalar or per
    slot (B,).  With ``sids`` the token at logical position pos + 1 draws
    from the (seed, sid, pos + 1) stream.  ``finite``, a bool tensor, is
    and-ed in place with "every logit of this step is finite" (no host
    sync)."""

    def serve_step(params, cache, batch, pos, seed, sids=None, finite=None):
        out, cache = M.decode_step(cfg, params, cache, batch, pos)
        logits = out["logits"][:, -1].float()
        if finite is not None:
            finite.logical_and_(torch.isfinite(logits).all())
        if sids is None:
            token = sample_slot_tokens(logits, seed, sample=sample)
        else:
            token = sample_slot_tokens(logits, seed, sample=sample,
                                       sids=sids, pos=pos + 1)
        value = out["value"][:, -1] if "value" in out else \
            torch.zeros(logits.shape[0], device=logits.device)
        return token, value, cache

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Chunked prefill for the serve engine:
    ``prefill_step(params, cache, batch, pos0=0, true_len=None) ->
    (logits (B, C, V) f32, cache)``.  None when the architecture's caches
    cannot be block-written."""
    if not M.supports_chunked_prefill(cfg):
        return None

    def prefill_step(params, cache, batch, pos0=0, true_len=None):
        out, cache = M.prefill_step(cfg, params, cache, batch, pos0,
                                    true_len)
        return out["logits"].float(), cache

    return prefill_step
