"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro/kernels/ref.py``'s oracles (and of the backward
formulas of ``repro/kernels/{rmsnorm,flash_attention_bwd}.py``), written
in PyTorch with the same arithmetic: f32 math, the finite ``NEG`` mask and
grouped query heads that never repeat the kv heads.  The CPU path of every
kernel wrapper runs these, and ``chip_smoke.py`` holds each CUDA kernel to
them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import kv_quant

NEG = -1e30
L_FLOOR = 1e-30     # floor on the softmax denominator (never a division by 0)

# The rounding of the bf16 flash kernels against these f32 plain versions.
# The TPU kernels, and the bf16 arms of the CUDA flash kernels, round p
# (forward; dv in the backward) and ds (dq, dk) once to bf16 before a
# product.  Each rounded factor is off by at most 2**-9 of itself (the bf16
# unit roundoff), so an output that sums such terms is off by at most 2**-9
# of the same sum over absolute values (``flash_round_scale``); ROUND_TOL
# is a factor of 2 above that bound, for the f32 sums around it.  lse is
# never rounded and keeps the f32 tolerance.
ROUND_TOL = 2.0 ** -8


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6, save_residuals: bool = False):
    """y = x * rsqrt(mean(x^2) + eps) * scale in f32, cast to x's dtype.
    With ``save_residuals`` also the per-row rsqrt(mean(x^2) + eps), f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf * rstd * scale).to(x.dtype)
    return (y, rstd[..., 0]) if save_residuals else y


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                    dy: torch.Tensor):
    """The one-pass RMSNorm backward (``rmsnorm.py::_bwd_kernel``): x, dy
    (rows, d); scale (d,); rstd (rows,) f32 -> (dx (rows, d) in x's dtype,
    dscale (d,) f32)."""
    xf, dyf = x.float(), dy.float()
    r = rstd[:, None]
    dys = dyf * scale
    c = (dys * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    dx = ((dys - xf * (r * r) * c) * r).to(x.dtype)
    return dx, (dyf * xf * r).sum(dim=0)


def rmsprop_update_ref(g: torch.Tensor, grad: torch.Tensor, *, lr: float,
                       alpha: float = 0.99, eps: float = 0.1):
    """Paper Eq. 8-9 (non-centred RMSProp with shared statistics), f32:
    returns (new_g, update); the caller subtracts update."""
    new_g = alpha * g + (1.0 - alpha) * grad.square()
    return new_g, lr * grad / torch.sqrt(new_g + eps)


def _train_mask(sq: int, causal: bool, window: Optional[int], device,
                sk: Optional[int] = None, q_offset: int = 0):
    """(Sq, Sk) validity of key t for query s: query row s at position
    q_offset + s, key row t at position t (Sk = Sq without an offset)."""
    sk = sq if sk is None else sk
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _train_logits(q, k, causal: bool, window: Optional[int],
                  q_offset: int = 0):
    """Masked, scaled f32 scores (B, Sq, Hkv, G, Sk) of the grouped heads,
    query row i at position q_offset + i against key row j at j."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) * d ** -0.5
    mask = _train_mask(s, causal, window, q.device, k.shape[1], q_offset)
    return torch.where(mask[None, :, None, None, :], logits, NEG)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """q (B,S,Hq,D); k,v (B,S,Hkv,D) -> (out (B,S,Hq,D), lse (B,Hq,S) f32):
    softmax in f32, and the per-row log-sum-exp of the masked scores, the
    statistic the backward rebuilds p from.  With ``q_offset`` q is one
    shard of a longer sequence: q (B,Sq,Hq,D) at positions q_offset ..
    q_offset + Sq - 1 against k, v (B,Sk,Hkv,D) of the whole, Sq +
    q_offset <= Sk; out (B,Sq,Hq,D), lse (B,Hq,Sq)."""
    b, s, hq, d = q.shape
    logits = _train_logits(q, k, causal, window, q_offset)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    o = o.reshape(b, s, hq, d).to(q.dtype).contiguous()
    lse = torch.logsumexp(logits, dim=-1).reshape(b, s, hq).transpose(1, 2)
    return o, lse.contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0):
    """FlashAttention-2 backward from the saved lse, with the formulas of
    ``flash_attention_bwd.py``: p = exp(s - lse), delta = rowsum(do * o),
    ds = p * (dp - delta) * scale.  p and ds stay in f32: this is the exact
    yardstick.  The TPU kernel and the CUDA kernel's bf16 arm round them to
    bf16 before their products (the f32 arm does not); ``ROUND_TOL`` times
    ``flash_round_scale`` bounds what that rounding moves.  Returns (dq, dk,
    dv) in the input dtypes, dk and dv summed over each kv head's G query
    heads.  With ``q_offset`` (``flash_attention_ref``'s shard) dq covers
    the shard's Sq rows and dk, dv all Sk keys: this shard's part of
    them, zero where none of its queries reaches a key."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    logits = _train_logits(q, k, causal, window, q_offset)  # (B,S,Hkv,G,Sk)
    lse_g = lse.transpose(1, 2).reshape(b, s, hkv, g, 1)
    p = torch.exp(logits - lse_g)
    dog = do.reshape(b, s, hkv, g, d).float()
    delta = (dog * o.reshape(b, s, hkv, g, d).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float())
    ds = p * (dp - delta) * scale
    qg = q.reshape(b, s, hkv, g, d).float()
    dq = torch.einsum("bshgt,bthd->bshgd", ds, k.float()).reshape(b, s, hq, d)
    dk = torch.einsum("bshgt,bshgd->bthd", ds, qg)
    dv = torch.einsum("bshgt,bshgd->bthd", p, dog)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def flash_round_scale(q, k, v, o, lse, do=None, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0):
    """The sums over absolute terms that bound the bf16 rounding of p and ds
    (``ROUND_TOL``), from the true (f32) p and ds of the plain versions:
    sum_j p_ij |v_j| for o, and with ``do`` also sum_j |ds_ij| |k_j| for dq,
    sum_i |ds_ij| |q_i| for dk and sum_i p_ij |do_i| for dv (dk and dv
    summed over each kv head's query heads).  o and lse are the plain
    forward's.  Returns (o, dq, dk, dv) scales in f32 (the last three None
    without ``do``); ``q_offset`` as in ``flash_attention_ref``."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    logits = _train_logits(q, k, causal, window, q_offset)
    p = torch.exp(logits - lse.transpose(1, 2).reshape(b, s, hkv, g, 1))
    o_s = torch.einsum("bshgt,bthd->bshgd", p,
                       v.float().abs()).reshape(b, s, hq, d)
    if do is None:
        return o_s, None, None, None
    dog = do.reshape(b, s, hkv, g, d).float()
    delta = (dog * o.reshape(b, s, hkv, g, d).float()).sum(-1, keepdim=True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float())
    ds = (p * (dp - delta) * d ** -0.5).abs()
    qg = q.reshape(b, s, hkv, g, d).float().abs()
    dq_s = torch.einsum("bshgt,bthd->bshgd", ds,
                        k.float().abs()).reshape(b, s, hq, d)
    dk_s = torch.einsum("bshgt,bshgd->bthd", ds, qg)
    dv_s = torch.einsum("bshgt,bshgd->bthd", p, dog.abs())
    return o_s, dq_s, dk_s, dv_s


def _decode_logits(q, k_cache, kpos, pos):
    """Masked, scaled f32 scores (B, Hkv, G, L) of one query token per row
    against its cache; lockstep kpos (L,) and pos () broadcast."""
    b, hq, d = q.shape
    length, hkv = k_cache.shape[1], k_cache.shape[2]
    kpos = kpos.expand(b, length)
    pos = torch.as_tensor(pos, device=q.device).expand(b)
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    logits = torch.einsum("bhgd,blhd->bhgl", qg, k_cache.float()) * d ** -0.5
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    return torch.where(valid[:, None, None, :], logits, NEG)


def decode_attention_ref(q, k_cache, v_cache, kpos, pos) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) absolute position per slot
    (-1 = empty); pos (B,) current position per sequence -> (B,Hq,D).
    Lockstep shapes (kpos (L,), pos ()) broadcast to every row."""
    b, hq, d = q.shape
    p = torch.softmax(_decode_logits(q, k_cache, kpos, pos), dim=-1)
    o = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def _append_mask(q, kpos, pos0: int, window: Optional[int]):
    """(B, C, 1, 1, Sk) validity of key row j for chunk row i at absolute
    position pos0 + i; kpos (B,Sk) or (Sk,)."""
    b, c = q.shape[:2]
    kpos = kpos.expand(b, kpos.shape[-1])
    qpos = pos0 + torch.arange(c, device=q.device)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    if window is not None:
        mask &= kpos[:, None, :] > qpos[None, :, None] - window
    return mask[:, :, None, None, :]


def _append_logits(q, k, kpos, pos0: int, window: Optional[int]):
    """Masked, scaled f32 scores (B, C, Hkv, G, Sk) of a chunk at absolute
    positions pos0 + i against its key stream; kpos (B,Sk) or (Sk,)."""
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, d).float()
    logits = torch.einsum("bshgd,bthd->bshgt", qg, k.float()) * d ** -0.5
    return torch.where(_append_mask(q, kpos, pos0, window), logits, NEG)


def flash_attention_append_ref(q, k, v, kpos, *, pos0: int,
                               window: Optional[int] = None) -> torch.Tensor:
    """q (B,C,Hq,D) at absolute positions pos0 + i; k,v (B,Sk,Hkv,D) the
    key stream (cache prefix + chunk); kpos (B,Sk) [or (Sk,)] absolute
    position per key row (-1 = invalid) -> (B,C,Hq,D).  Causal (and
    windowed) on absolute positions."""
    b, c, hq, d = q.shape
    p = torch.softmax(_append_logits(q, k, kpos, pos0, window), dim=-1)
    o = torch.einsum("bshgt,bthd->bshgd", p, v.float())
    return o.reshape(b, c, hq, d).to(q.dtype)


def append_round_scale(q, k, v, kpos, *, pos0: int,
                       window: Optional[int] = None) -> torch.Tensor:
    """The append analogue of ``flash_round_scale``: sum_j p_ij |v_j| from
    the true (f32) p of ``flash_attention_append_ref``, (B,C,Hq,D) f32.
    The bf16 arm rounds p to bf16 before P V (the TPU kernel's
    p.astype(v.dtype)), which moves o by at most ``ROUND_TOL`` times it."""
    b, c, hq, d = q.shape
    p = torch.softmax(_append_logits(q, k, kpos, pos0, window), dim=-1)
    o_s = torch.einsum("bshgt,bthd->bshgd", p, v.float().abs())
    return o_s.reshape(b, c, hq, d)


def decode_attention_partials_ref(q, k_cache, v_cache, kpos, pos,
                                  k_scale=None, v_scale=None):
    """Flash-decoding partials over a (local) cache slice: the arguments of
    ``decode_attention_ref`` (int8 caches with their (B,L,Hkv,1) f32
    scales) -> the unnormalised online-softmax state (acc (B,Hkv,G,D),
    m (B,Hkv,G), l (B,Hkv,G)), all f32.  A masked key scores the finite
    NEG, so a fully masked slice gives m = NEG, l = its number of keys and
    acc = the sum of its v rows (the TPU kernel's semantics)."""
    if k_scale is not None:
        k_cache = dequant_ref(k_cache, k_scale)
        v_cache = dequant_ref(v_cache, v_scale)
    logits = _decode_logits(q, k_cache, kpos, pos)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhgl,blhd->bhgd", p, v_cache.float())
    return acc, m, p.sum(dim=-1)


def combine_partials(parts):
    """Combine (acc, m, l) partials of disjoint cache slices into the
    attention output (B, Hq, D) f32: o = sum(acc * e^(m - max m)) /
    sum(l * e^(m - max m)), the cross-shard combine of the context-parallel
    decode (``repro/kernels/dispatch.py::_decode_cp_call``) taken here over
    a list.  A slice that others outweigh vanishes (its correction
    underflows to 0); a row masked everywhere keeps the mean of v."""
    m_max = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    corr = [torch.exp(m - m_max) for _, m, _ in parts]
    l_tot = sum(l * c for (_, _, l), c in zip(parts, corr))
    acc_tot = sum(acc * c[..., None] for (acc, _, _), c in zip(parts, corr))
    o = acc_tot / torch.clamp(l_tot, min=L_FLOOR)[..., None]
    b, hkv, g, d = o.shape
    return o.reshape(b, hkv * g, d)


def decode_split_ref(q, k_cache, v_cache, kpos, pos, k_scale=None,
                     v_scale=None, *, tiles_per_split: int, tile: int = 64,
                     partials: bool = False):
    """A plain model of the CUDA decode kernel's algorithm, for tests and
    ``chip_smoke.py`` only: the key range cut into splits of
    ``tiles_per_split`` tiles of ``tile`` rows; where the row (slot or
    slice) holds a valid key, a tile without one is skipped (its keys
    absent); each split's (acc, m, l), m = NEG where it visits no valid
    key; the splits combined in split order.  Arguments as
    ``decode_attention_partials_ref``; returns its (acc, m, l) with
    ``partials``, else the normalised (B, Hq, D) in q's dtype."""
    if k_scale is not None:
        k_cache = dequant_ref(k_cache, k_scale)
        v_cache = dequant_ref(v_cache, v_scale)
    b, hq, d = q.shape
    length = k_cache.shape[1]
    logits = _decode_logits(q, k_cache, kpos, pos)          # (B,Hkv,G,L)
    kpos = kpos.expand(b, length)
    pos = torch.as_tensor(pos, device=q.device).expand(b)
    valid = (kpos >= 0) & (kpos <= pos[:, None])             # (B, L)
    n_tiles = -(-length // tile)
    pad = n_tiles * tile - length
    tile_live = torch.nn.functional.pad(valid, (0, pad)).reshape(
        b, n_tiles, tile).any(-1)
    visit = tile_live | ~valid.any(-1, keepdim=True)         # (B, tiles)
    visit = visit.repeat_interleave(tile, dim=1)[:, :length]
    logits = torch.where(visit[:, None, None, :], logits, -torch.inf)
    v = v_cache.float()
    parts = []
    span = tiles_per_split * tile
    for s0 in range(0, length, span):
        lg = logits[..., s0:s0 + span]
        m = torch.clamp(lg.amax(dim=-1), min=NEG)
        p = torch.exp(lg - m[..., None])
        parts.append((torch.einsum("bhgl,blhd->bhgd", p, v[:, s0:s0 + span]),
                      m, p.sum(dim=-1)))
    m_tot = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    l_tot = torch.zeros_like(m_tot)
    acc_tot = torch.zeros_like(parts[0][0])
    for acc, m, l in parts:
        c = torch.exp(m - m_tot)
        l_tot = l_tot + l * c
        acc_tot = acc_tot + acc * c[..., None]
    if partials:
        return acc_tot, m_tot, l_tot
    o = acc_tot / torch.clamp(l_tot, min=L_FLOOR)[..., None]
    return o.reshape(b, hq, d).to(q.dtype)


def append_int8_mma_ref(q, k, v, k_scale, v_scale, kpos, *, pos0: int,
                        window: Optional[int] = None,
                        split: bool = True) -> torch.Tensor:
    """A plain model of the arithmetic of the append kernel's int8
    tensor-core arm, for tests only: K and V taken as their integers (exact
    in bf16), each score q . k_int times its key's k scale after the
    product, p in f32 (l sums it), w = p * the key's v scale split into
    hi = bf16(w) and lo = bf16(w - hi), and acc = sum (hi + lo) v_int in
    f32.  ``split=False`` keeps only hi (p * v scale rounded once to bf16,
    as a bf16 P V product would): the model the kernel must not be.
    Arguments as ``flash_attention_append_quant_ref``; returns (B,C,Hq,D)
    in q's dtype."""
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, d).float()
    raw = torch.einsum("bshgd,bthd->bshgt", qg, k.float())
    ks = k_scale[..., 0].transpose(1, 2)[:, None, :, None, :]
    vs = v_scale[..., 0].transpose(1, 2)[:, None, :, None, :]
    logits = torch.where(_append_mask(q, kpos, pos0, window),
                         raw * ks * d ** -0.5, NEG)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = p * vs
    hi = w.to(torch.bfloat16).float()
    acc = torch.einsum("bshgt,bthd->bshgd", hi, v.float())
    if split:
        lo = (w - hi).to(torch.bfloat16).float()
        acc = acc + torch.einsum("bshgt,bthd->bshgd", lo, v.float())
    o = acc / torch.clamp(p.sum(dim=-1), min=L_FLOOR)[..., None]
    return o.reshape(b, c, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# int8 KV: each quant plain version is the standalone dequantisation
# (``kv_quant.dequantize``) composed with the float plain version, so a
# kernel that dequantises inside its body must match dequantise-then-attend
# ---------------------------------------------------------------------------

def dequant_ref(q8, scale, dtype=torch.float32) -> torch.Tensor:
    return kv_quant.dequantize(q8, scale, dtype)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale, kpos,
                               pos) -> torch.Tensor:
    """``decode_attention_ref`` over int8 caches with (B,L,Hkv,1) scales."""
    return decode_attention_ref(q, dequant_ref(k_cache, k_scale),
                                dequant_ref(v_cache, v_scale), kpos, pos)


def flash_attention_append_quant_ref(q, k, v, k_scale, v_scale, kpos, *,
                                     pos0: int,
                                     window: Optional[int] = None
                                     ) -> torch.Tensor:
    """``flash_attention_append_ref`` over an int8 key stream with
    (B,Sk,Hkv,1) scales."""
    return flash_attention_append_ref(q, dequant_ref(k, k_scale),
                                      dequant_ref(v, v_scale), kpos,
                                      pos0=pos0, window=window)


# ---------------------------------------------------------------------------
# paged KV: a shared page pool (P, page_size, Hkv, D) behind per-slot page
# tables (B, M) int32, -1 = unmapped; page 0 is the garbage sink.  The paged
# plain versions gather the dense view and run the contiguous ones.
# ---------------------------------------------------------------------------

def paged_rows(page_table) -> torch.Tensor:
    """The pool rows a gather through ``page_table`` (B, M) reads: the
    table flattened to (B * M,) int64, unmapped entries on the sink."""
    return page_table.clamp(min=0).reshape(-1).long()


def paged_gather_ref(pool, page_table, rows=None) -> torch.Tensor:
    """(B, M * page_size, Hkv, D) dense view of ``pool`` through
    ``page_table``; unmapped rows gather page 0 (callers mask them through
    kpos).  ``rows``: ``paged_rows(page_table)``, if already computed."""
    b, m = page_table.shape
    rows = paged_rows(page_table) if rows is None else rows
    dense = pool.index_select(0, rows)              # (B * M, ps, Hkv, D)
    return dense.reshape(b, m * pool.shape[1], *pool.shape[2:])


def paged_kpos_ref(page_table, page_size: int) -> torch.Tensor:
    """kpos of a page-gathered view: row i holds absolute position i iff
    its page is mapped, else -1.  (B, M) -> (B, M * page_size) int32."""
    b, m = page_table.shape
    mapped = (page_table >= 0).repeat_interleave(page_size, dim=1)
    idx = torch.arange(m * page_size, dtype=torch.int32,
                       device=page_table.device)
    return torch.where(mapped, idx, -1)


def paged_view(pool, page_table, length, rows=None):
    """``paged_gather_ref`` cut to the first ``length`` rows."""
    return paged_gather_ref(pool, page_table, rows)[:, :length]


def decode_attention_paged_ref(q, k_pool, v_pool, page_table, pos, *,
                               length: Optional[int] = None) -> torch.Tensor:
    """The gathered view statically cut to ``length`` rows, then
    ``decode_attention_ref``."""
    kpos = paged_kpos_ref(page_table, k_pool.shape[1])[:, :length]
    return decode_attention_ref(q, paged_view(k_pool, page_table, length),
                                paged_view(v_pool, page_table, length),
                                kpos, pos)


def decode_attention_paged_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     page_table, pos, *,
                                     length: Optional[int] = None
                                     ) -> torch.Tensor:
    """int8 pools with (P, page_size, Hkv, 1) f32 scale pools, gathered
    through the same table."""
    kpos = paged_kpos_ref(page_table, k_pool.shape[1])[:, :length]
    return decode_attention_quant_ref(
        q, paged_view(k_pool, page_table, length),
        paged_view(v_pool, page_table, length),
        paged_view(k_scale, page_table, length),
        paged_view(v_scale, page_table, length), kpos, pos)


def prefix_table(page_table, page_size: int, pos0: int):
    """The table's entries for the pages that cover [0, pos0)."""
    return page_table[:, :-(-pos0 // page_size)]


def append_paged_kpos(page_table, page_size: int, pos0: int,
                      c: int) -> torch.Tensor:
    """kpos (B, pos0 + C) int32 of a paged append's key stream: the
    gathered prefix [0, pos0), then the chunk at pos0 + i."""
    b = page_table.shape[0]
    chunk = (pos0 + torch.arange(c, dtype=torch.int32,
                                 device=page_table.device)).expand(b, c)
    if pos0 == 0:
        return chunk
    pre = paged_kpos_ref(prefix_table(page_table, page_size, pos0),
                         page_size)[:, :pos0]
    return torch.cat([pre, chunk], dim=1)


def verify_paged_kpos(page_table, page_size: int, pos, length: int,
                      k: int) -> torch.Tensor:
    """kpos (B, length + K) int32 of a paged verify's key stream: the
    gathered view cut to ``length`` rows with every row at or past the
    slot's ``pos`` masked (pages mapped ahead of a verify hold rows no
    commit wrote), then the chunk at pos + i."""
    pre = paged_kpos_ref(page_table, page_size)[:, :length]
    pos = pos.to(torch.int32)[:, None]
    pre = torch.where(pre <= pos - 1, pre, -1)
    chunk = pos + torch.arange(k, dtype=torch.int32,
                               device=page_table.device)
    return torch.cat([pre, chunk], dim=1)


def append_paged_stream(pools, page_table, chunks, pos0: int,
                        page_size: int, cast: bool = False, rows=None):
    """Key stream of a paged append: each pool's gathered prefix [0, pos0)
    (with ``cast``, in its chunk's dtype) followed by its chunk.
    ``rows``: ``paged_rows`` of the prefix's table, if already computed."""
    if pos0 == 0:
        return list(chunks)
    pt = prefix_table(page_table, page_size, pos0)
    out = []
    for pool, chunk in zip(pools, chunks):
        pre = paged_view(pool, pt, pos0, rows)
        out.append(torch.cat([pre.to(chunk.dtype) if cast else pre,
                              chunk], dim=1))
    return out


def flash_attention_append_paged_ref(q, k_pool, v_pool, page_table,
                                     k_chunk, v_chunk, *,
                                     pos0: int) -> torch.Tensor:
    """The gathered prefix [0, pos0) in q's dtype plus the chunk's own K/V,
    then ``flash_attention_append_ref`` (no window: ring layers stay
    contiguous)."""
    ps = k_pool.shape[1]
    k, v = append_paged_stream((k_pool, v_pool), page_table,
                               (k_chunk, v_chunk), pos0, ps, cast=True)
    kpos = append_paged_kpos(page_table, ps, pos0, q.shape[1])
    return flash_attention_append_ref(q, k, v, kpos, pos0=pos0)


def flash_attention_append_paged_quant_ref(q, k_pool, v_pool, k_scale,
                                           v_scale, page_table, k_chunk,
                                           v_chunk, ks_chunk, vs_chunk, *,
                                           pos0: int) -> torch.Tensor:
    """int8 pools and scale pools hold the prefix; the chunk comes already
    quantised (the bytes its cache write lands)."""
    ps = k_pool.shape[1]
    k, v, ks, vs = append_paged_stream(
        (k_pool, v_pool, k_scale, v_scale), page_table,
        (k_chunk, v_chunk, ks_chunk, vs_chunk), pos0, ps)
    kpos = append_paged_kpos(page_table, ps, pos0, q.shape[1])
    return flash_attention_append_quant_ref(q, k, v, ks, vs, kpos, pos0=pos0)
