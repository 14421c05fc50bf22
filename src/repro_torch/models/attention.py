"""Grouped-query attention with RoPE, sliding windows and KV caches.

Counterpart of ``repro/models/attention.py`` for the training path and,
on the contiguous cache layout, the serving path:

  * ``attend_train``   — full-sequence causal (or bidirectional) attention
    through the differentiable flash kernels;
  * ``attend_decode``  — one new token per slot against its KV cache;
  * ``attend_prefill`` — one prompt chunk, written into the cache and
    attended through the append kernel;
  * ``attend_verify``  — a speculative draft chunk a slot, scored through
    the append kernel without writing anything; ``commit_kv`` then writes
    the accepted rows;
  * ``cross_attend``   — the Whisper decoder's attention over the encoder
    memory's K/V (``memory_kv``), plain products as in the reference.

``attend_train`` and ``attend_decode`` take ``use_rope=False`` for
Whisper's self attention, which has no rotary embedding.

Caches are updated in place (the JAX functions return new caches; here the
same dict comes back with its tensors written), which keeps one copy of
each cache on the card.  An int8 cache stores int8 ``k``/``v`` rows with
per-(row, kv head) f32 scales ``ks``/``vs`` (quantised on write,
dequantised inside the kernels).  Under the ``decode_cp`` rules
(``distributed/sharding.py``) a cache whose length divides over the ranks
is laid out as this rank's slice of the sequence dim: ``init_kv_cache``
allocates it and records the global length, ``attend_decode`` writes a new
row only on the rank that owns its slot and attends through the
context-parallel combine.

A paged cache (``init_paged_kv_cache``) keeps a layer's rows in a shared
page pool ``kp``/``vp`` (n_pages, page_size, Hkv, D) (int8: scale pools
``kps``/``vps``) behind a page table ``pt`` (batch, cache_len / page_size)
int32, -1 unmapped; page 0 is the garbage sink that writes through
unmapped entries land in (several a step, each target's last writer the
one defined: ``_write_pool``).  Every layer of a model references one ``pt``
tensor.  Writes go through the table; reads gather the dense view and run
the contiguous kernels (``dispatch.decode_attention_paged``,
``dispatch.flash_attention_append_paged``).  Ring (windowed) layers stay
contiguous inside a paged model cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import collectives, ctx
from repro_torch.distributed.sharding import (DecodeCPSpec,
                                              decode_cp_shard_spec,
                                              decode_cp_spec)
from repro_torch.kernels import dispatch, kv_quant, ref
from repro_torch.models import common as cm

def attention_shapes(d_model: int, n_heads: int, n_kv_heads: int,
                     head_dim: int, *, qkv_bias: bool = False) -> dict:
    def lin(d_in, d_out, bias):
        p = {"w": (d_in, d_out)}
        if bias:
            p["b"] = (d_out,)
        return p
    return {"wq": lin(d_model, n_heads * head_dim, qkv_bias),
            "wk": lin(d_model, n_kv_heads * head_dim, qkv_bias),
            "wv": lin(d_model, n_kv_heads * head_dim, qkv_bias),
            "wo": lin(n_heads * head_dim, d_model, False)}


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16,
                  device=None) -> dict:
    """Cache for one attention layer: ``k``/``v`` (batch, cache_len, Hkv,
    D) of ``dtype`` (f32, bf16 or int8).  An int8 cache adds zero f32
    scales ``ks``/``vs`` (batch, cache_len, Hkv, 1), rank-matched so every
    row copy treats them like the payload.  When the active ``decode_cp``
    rules own a cache of ``cache_len`` rows, only this rank's slice of
    cache_len / n_shards rows is allocated and ``global_len`` records
    cache_len.  The JAX cache's ``index`` leaf is written but never read
    there, so the port keeps no counterpart."""
    dtype = kv_quant.resolve_kv_dtype(dtype)
    cache = {}
    rows = cache_len
    cp = _decode_cp_rule(cache_len)
    if cp is not None:
        rows = cache_len // cp["n_shards"]
        cache["global_len"] = cache_len
    shape = (batch, rows, n_kv_heads, head_dim)
    cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
    cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    if kv_quant.is_quantized(dtype):
        for name in ("ks", "vs"):
            cache[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=device)
    return cache


class PagedLayout(NamedTuple):
    """A paged cache's static shape: pages of ``page_size`` rows in a pool
    of ``n_pages`` (page 0 the sink, never handed out)."""
    page_size: int
    n_pages: int


def init_paged_kv_cache(batch: int, cache_len: int, n_kv_heads: int,
                        head_dim: int, *, page_size: int, n_pages: int,
                        dtype=torch.bfloat16, device=None,
                        pt: Optional[torch.Tensor] = None) -> dict:
    """Paged cache for one attention layer: pools ``kp``/``vp`` (n_pages,
    page_size, Hkv, D) of ``dtype`` (int8: zero f32 scale pools
    ``kps``/``vps`` (n_pages, page_size, Hkv, 1)) and the page table
    ``pt`` (batch, cache_len // page_size) int32, all -1, or ``pt`` itself
    when given (the table the model's layers share).  ``cache_len`` must be
    whole pages: the gathered view then has the contiguous layout's shape
    exactly."""
    if cache_len % page_size:
        raise ValueError(f"cache_len {cache_len} must be a multiple of "
                         f"page_size {page_size} (whole-page slots)")
    dtype = kv_quant.resolve_kv_dtype(dtype)
    if pt is None:
        pt = torch.full((batch, cache_len // page_size), -1,
                        dtype=torch.int32, device=device)
    shape = (n_pages, page_size, n_kv_heads, head_dim)
    cache = {"kp": torch.zeros(shape, dtype=dtype, device=device),
             "vp": torch.zeros(shape, dtype=dtype, device=device), "pt": pt}
    if kv_quant.is_quantized(dtype):
        for name in ("kps", "vps"):
            cache[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=device)
    return cache


def pool_leaves(cache: dict):
    """A paged cache's page-indexed leaves: kp, vp and, for int8, kps,
    vps."""
    return [n for n in ("kp", "vp", "kps", "vps") if n in cache]


class PagedIndex(NamedTuple):
    """A page table read for one decode step or prefill chunk, the same
    for every layer that shares the table: computed once, not once a
    layer.  ``rows`` are the gather's pool rows (``ref.paged_rows``),
    ``kpos`` the key stream's positions; the new rows land in pages
    ``page`` at rows ``off`` ((B,) a step, (B, C) a chunk; the sink where
    unmapped or masked)."""
    rows: torch.Tensor
    kpos: torch.Tensor
    page: torch.Tensor
    off: torch.Tensor


def decode_index(pt: torch.Tensor, page_size: int,
                 pos: torch.Tensor) -> PagedIndex:
    """The ``PagedIndex`` of a decode step at per-slot positions pos (B,)."""
    slots = torch.arange(pt.shape[0], device=pt.device)
    page = pt[slots, (pos // page_size).long()].clamp(min=0).long()
    return PagedIndex(ref.paged_rows(pt), ref.paged_kpos_ref(pt, page_size),
                      page, (pos % page_size).long())


def prefill_index(pt: torch.Tensor, page_size: int, pos0: int, c: int,
                  true_len: Optional[torch.Tensor] = None) -> PagedIndex:
    """The ``PagedIndex`` of a prefill chunk [pos0, pos0 + C): writes of
    unmapped pages and of positions >= ``true_len`` go to the sink (a
    right-padded row must not clobber a page another slot shares)."""
    b = pt.shape[0]
    positions = pos0 + torch.arange(c, device=pt.device)
    pages = pt[:, positions // page_size].long()            # (B, C)
    end = torch.full((b,), pos0 + c, device=pt.device)
    if true_len is not None:
        end = torch.minimum(end, true_len.to(end.device, end.dtype))
    valid = (positions[None, :] < end[:, None]) & (pages > 0)
    return PagedIndex(
        ref.paged_rows(ref.prefix_table(pt, page_size, pos0)),
        ref.append_paged_kpos(pt, page_size, pos0, c),
        torch.where(valid, pages, 0),
        (positions % page_size)[None, :].expand(b, c))


def verify_index(pt: torch.Tensor, page_size: int, pos: torch.Tensor,
                 k: int) -> PagedIndex:
    """The ``PagedIndex`` of a verify chunk of K rows at per-slot positions
    pos (B,) + i: the key stream's kpos (the whole view, rows at or past
    pos masked, then the chunk) and the commit's targets (B, K), the sink
    where unmapped."""
    m = pt.shape[1]
    positions = pos[:, None].long() + torch.arange(k, device=pt.device)
    pidx = (positions // page_size).clamp(max=m - 1)
    page = torch.gather(pt, 1, pidx).clamp(min=0).long()
    return PagedIndex(ref.paged_rows(pt),
                      ref.verify_paged_kpos(pt, page_size, pos,
                                            m * page_size, k),
                      page, positions % page_size)


def model_paged_index(model_cache: dict, *, pos=None, pos0: int = 0,
                      c: int = 0, true_len=None,
                      verify: bool = False) -> Optional[PagedIndex]:
    """The ``PagedIndex`` of a model cache's shared page table for a decode
    step at ``pos`` (with ``verify``, a verify chunk of ``c`` rows there),
    or else a prefill chunk (None without a table)."""
    if "pt" not in model_cache:
        return None
    ps = next(layer["kp"].shape[1] for layer in model_cache["layers"]
              if "kp" in layer)
    if pos is not None:
        if verify:
            return verify_index(model_cache["pt"], ps, pos, c)
        return decode_index(model_cache["pt"], ps, pos)
    return prefill_index(model_cache["pt"], ps, pos0, c, true_len)


def _new_pool_rows(k, v, quant: bool) -> dict:
    """New K/V rows under the pool leaves' names, quantised for int8."""
    if not quant:
        return {"kp": k, "vp": v}
    (kq, ks), (vq, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
    return {"kp": kq, "vp": vq, "kps": ks, "vps": vs}


def _last_writer(page: torch.Tensor, off: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """For each write of a pool scatter (flattened in row order) the index
    of the last write to the same (page, row).  Duplicate targets come
    from the page-0 sink, which idle slots, padding rows and rejected
    drafts all write: each then carries the last one's value, so the last
    writer is the one defined writer whatever order the device applies
    the writes in, and the sink holds what XLA's scatter leaves there (its
    last write) on every device and thread count.  Distinct targets keep
    their own rows.  No host sync: an (n, n) comparison of n writes."""
    key = (page.long() * page_size + off.long()).reshape(-1)
    idx = torch.arange(key.numel(), device=key.device)
    same = key[:, None] == key[None, :]
    return torch.where(same, idx[None, :], -1).amax(dim=1)


def _write_pool(cache: dict, name: str, page: torch.Tensor,
                off: torch.Tensor, rows: torch.Tensor) -> None:
    """Pool leaf ``name`` written at (page, off) (any shape S) with
    ``rows`` (S + the row's trailing dims), each target's last writer
    defined (``_last_writer``)."""
    pool = cache[name]
    last = _last_writer(page, off, pool.shape[1])
    flat = rows.reshape((-1,) + tuple(rows.shape[page.dim():]))[last]
    pool[page.reshape(-1), off.reshape(-1)] = flat.to(pool.dtype)


def _check_no_window(window: Optional[int]) -> None:
    if window is not None:
        raise ValueError("paged KV caches do not support sliding windows; "
                         "keep ring layers contiguous")


def _decode_cp_rule(cache_len: int) -> Optional[dict]:
    """The active ``decode_cp`` rule when it owns a cache of ``cache_len``
    rows (one whole slice per shard), else None: the cache is then
    replicated, the JAX package's choice for a length that does not
    divide."""
    cp = (ctx.current_rules() or {}).get("decode_cp")
    if cp is None or decode_cp_shard_spec(cp, length=cache_len)[0] is None:
        return None
    return cp


def cp_layout(cache: dict) -> Optional[DecodeCPSpec]:
    """The context-parallel layout of a cache slice (None for a whole
    cache).  A slice is only ever attended under the rules that laid it
    out: alone it would attend to a fraction of the keys."""
    if "global_len" not in cache:
        return None
    length = cache["global_len"]
    cp = _decode_cp_rule(length)
    if cp is None:
        raise ValueError(f"a context-parallel cache slice of {length} rows "
                         "is used outside the decode_cp rules that laid it "
                         "out")
    return decode_cp_spec(cp, length=length)


def kv_leaves(cache: dict):
    """The cache's row-indexed leaves: k, v and, for int8, ks, vs."""
    return [n for n in ("k", "v", "ks", "vs") if n in cache]


def _update_kv_cache_cp(cache: dict, new: dict, slot: torch.Tensor,
                        cp: DecodeCPSpec) -> None:
    """Write each row's new K/V (and, int8, its scales) on the rank that
    owns its slot only: rank r holds global slots [r * l_loc,
    (r + 1) * l_loc).  ``new`` maps leaf names to (B, 1, ...) rows; slot
    (B,) is per batch row.  A predicated write (gather, select, scatter),
    as the JAX shard_map write, with no host sync."""
    b = slot.shape[0]
    local = slot - cp.start
    in_range = (local >= 0) & (local < cp.l_loc)
    ls = local.clamp(0, cp.l_loc - 1)
    rows = torch.arange(b, device=slot.device)
    for name, rows_new in new.items():
        leaf = cache[name]
        old = leaf[rows, ls]
        leaf[rows, ls] = torch.where(in_range[:, None, None],
                                     rows_new[:, 0].to(leaf.dtype), old)


def _rope(cfg, positions: torch.Tensor):
    """Plain RoPE tables (cos, sin) at ``positions``."""
    return cm.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _qkv(params: dict, x: torch.Tensor, cfg, cos: Optional[torch.Tensor],
         sin: Optional[torch.Tensor]):
    """q, k, v, the rotary tables (cos, sin) applied to q and k (none
    where ``cos`` is None: Whisper's attention has no rotary).  The head
    counts are the leaves' own (this rank's heads under tensor
    parallelism)."""
    hd = cfg.hd
    q = _split_heads(cm.linear(params["wq"], x),
                     params["wq"]["w"].shape[1] // hd, hd)
    k = _split_heads(cm.linear(params["wk"], x),
                     params["wk"]["w"].shape[1] // hd, hd)
    v = _split_heads(cm.linear(params["wv"], x),
                     params["wv"]["w"].shape[1] // hd, hd)
    if cos is not None:
        q = cm.apply_rope(q, cos, sin, rotary_dim=cfg.rotary_dim)
        k = cm.apply_rope(k, cos, sin, rotary_dim=cfg.rotary_dim)
    return q, k, v


def _kv_heads_read(cfg, tp) -> Tuple[int, int]:
    """(first, count) of the kv heads this rank's q heads read when the kv
    heads do not divide the model axis: q heads [r hq / tp, (r + 1) hq /
    tp) read kv head h // g, g = hq / hkv.  The local heads must group
    evenly (each kv head read by as many consecutive local q heads), as
    every config's do (their q heads lie in one group)."""
    hq_loc = cfg.n_heads // tp.size
    g = cfg.n_heads // cfg.n_kv_heads
    q0 = tp.rank * hq_loc
    reads = [h // g for h in range(q0, q0 + hq_loc)]
    first, count = reads[0], reads[-1] - reads[0] + 1
    if hq_loc % count or any(reads[i] != first + i // (hq_loc // count)
                             for i in range(hq_loc)):
        raise ValueError(f"{cfg.name}: the q heads of model rank {tp.rank} "
                         f"({hq_loc} of {cfg.n_heads}) read the kv heads "
                         f"{reads}, which no GQA grouping covers")
    return first, count


def _kv_whole_params(params: dict, cfg, tp) -> dict:
    """Under tensor parallelism with kv heads that do not divide the model
    axis (``sharding.tp_holds`` holds ``wk``/``wv`` whole): the columns of
    the kv heads this rank's q heads read, taken from the whole leaves
    before the products.  Each rank's gradient of the whole leaves covers
    its own heads' use of them, so the model group sums it
    (``collectives.sum_grads``)."""
    first, count = _kv_heads_read(cfg, tp)
    lo, n = first * cfg.hd, count * cfg.hd
    out = dict(params)
    for name in ("wk", "wv"):
        out[name] = {key: collectives.sum_grads(t, tp.group).narrow(-1, lo, n)
                     for key, t in params[name].items()}
    return out


def attend_train(params: dict, x: torch.Tensor, cos: Optional[torch.Tensor],
                 sin: Optional[torch.Tensor], cfg, *,
                 window: Optional[int] = None, use_rope: bool = True,
                 bidirectional: bool = False, tp=None) -> torch.Tensor:
    """Full-sequence self attention.  x (B, S, d_model); cos, sin the
    caller's rotary tables ((1 or B, S, D/2): plain RoPE at 0 .. S-1 or
    M-RoPE, ``model._rope_tables``), unused with ``use_rope=False`` ->
    (B, S, d_model).

    Under tensor parallelism (``tp``, ``fsdp.TPRule``) x is the whole
    sequence gathered from the ranks' rows, the leaves are this rank's
    heads (``wq`` columns, ``wo`` rows; ``wk``/``wv`` too where the kv
    heads divide the model axis, else whole: ``_kv_whole_params``), the
    kernels see only the local heads, and the result is this rank's
    partial sum of the output projection, which the caller reduce-scatters
    (counted as the ``tp_heads`` and ``tp_kv_whole`` routes)."""
    b, s, _ = x.shape
    if not use_rope:
        cos = sin = None
    if tp is not None:
        dispatch.count_route("tp_heads")
        if params["wk"]["w"].shape[1] == cfg.n_kv_heads * cfg.hd \
                and cfg.n_kv_heads % tp.size:
            dispatch.count_route("tp_kv_whole")
            params = _kv_whole_params(params, cfg, tp)
    q, k, v = _qkv(params, x, cfg, cos, sin)
    o = dispatch.flash_attention(q, k, v, causal=not bidirectional,
                                 window=window)
    return cm.linear(params["wo"], o.reshape(b, s, -1))


def _gather_heads(tp, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Tensors (B, 1, h_i, D) of this rank's heads -> every rank's heads,
    in rank order, with one all-gather over the model group: the parts
    are laid side by side along the heads, gathered, and split back, each
    contiguous (the kernels take contiguous q)."""
    sizes = [t.shape[2] for t in ts]
    both = torch.cat(ts, dim=2) if len(ts) > 1 else ts[0]
    whole = collectives.gather_slice(both, tp.group, 2)
    b, s, _, d = whole.shape
    chunks = whole.reshape(b, s, tp.size, sum(sizes), d).split(sizes, 3)
    return tuple(c.reshape(b, s, tp.size * n, d).contiguous()
                 for c, n in zip(chunks, sizes))


def attend_decode(params: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor, cfg, *, window: Optional[int] = None,
                  use_rope: bool = True,
                  paged: Optional[PagedIndex] = None, tp=None):
    """One-token decode.  x (B, 1, d_model); pos the absolute position, a
    lockstep scalar () or per slot (B,) (every row decodes at its own
    depth: writes, RoPE and the validity mask are per row).

    Writes row ``pos % cache_len`` of each slot in place and returns
    (out (B, 1, d_model), cache).  With ``window`` the cache is a ring of
    length == window; otherwise cache_len covers every position.  An int8
    cache takes the row quantised, with its scale.  A context-parallel
    slice (``cp_layout``) takes the row only on the rank that owns its
    slot, and attends its own columns of the global kpos through the
    partials kernel and the combine across ranks.  A paged cache takes the
    row in page pt[pos // page_size] (the sink where unmapped) and attends
    its gathered view; ``paged`` is the step's ``decode_index``, which
    every layer sharing the table may share.

    Under the serving layout (``tp``, ``fsdp.TPRule``; x this rank's batch
    rows, whole on every model rank) the projections run on this rank's
    heads (all kv heads where ``wk``/``wv`` are held whole), q, k and v
    are all-gathered over the model group, since the context-parallel
    rule keeps the heads whole on each sequence shard (the reference's
    ``DecodeCPSpec.q_decode``/``.kv``), the kernels run on every head and
    the result is this rank's heads' partial sum of ``wo``, which the
    caller sums over the model group (the ``tp_decode_heads`` route).  A
    paged cache has no such layout."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).expand(b)
    q, k, v = _qkv(params, x, cfg, *(_rope(cfg, pos[:, None]) if use_rope
                                     else (None, None)))
    hq_loc = q.shape[2]
    if tp is not None:
        if "kp" in cache:
            raise ValueError("the serving layout decodes contiguous caches; "
                             "a page pool has no sequence slice")
        dispatch.count_route("tp_decode_heads")
        if k.shape[2] == cfg.n_kv_heads:
            (q,) = _gather_heads(tp, q)
        else:
            q, k, v = _gather_heads(tp, q, k, v)
    n = cfg.n_heads * cfg.hd
    if "kp" in cache:
        _check_no_window(window)
        ps = cache["kp"].shape[1]
        pt = cache["pt"]
        idx = paged if paged is not None else decode_index(pt, ps, pos)
        for name, new in _new_pool_rows(k, v, "kps" in cache).items():
            _write_pool(cache, name, idx.page, idx.off, new[:, 0])
        o = dispatch.decode_attention_paged(
            q[:, 0], cache["kp"], cache["vp"], pt, pos,
            length=pt.shape[1] * ps, k_scale=cache.get("kps"),
            v_scale=cache.get("vps"), kpos=idx.kpos, rows=idx.rows)[:, None]
        return cm.linear(params["wo"], o.reshape(b, 1, n)), cache
    new = {"k": k, "v": v}
    if "ks" in cache:
        new["k"], new["ks"] = kv_quant.quantize(k)      # (B,1,Hkv,{D,1})
        new["v"], new["vs"] = kv_quant.quantize(v)
    cp = cp_layout(cache)
    cache_len = cache.get("global_len", cache["k"].shape[1])
    slot = (pos % cache_len).long()
    if cp is not None:
        _update_kv_cache_cp(cache, new, slot, cp)
    else:
        rows = torch.arange(b, device=x.device)
        for name, rows_new in new.items():
            cache[name][rows, slot] = rows_new[:, 0].to(cache[name].dtype)
    kpos = _cache_positions(cache_len, pos, window)
    if cp is not None:
        kpos = kpos[:, cp.start:cp.start + cp.l_loc]
    o = dispatch.decode_attention(q[:, 0], cache["k"], cache["v"], kpos, pos,
                                  k_scale=cache.get("ks"),
                                  v_scale=cache.get("vs"), cp=cp)[:, None]
    if tp is not None:
        o = o.narrow(2, tp.rank * hq_loc, hq_loc)
        n = hq_loc * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, 1, n)), cache


def _cache_positions(cache_len: int, pos: torch.Tensor,
                     window: Optional[int]) -> torch.Tensor:
    """Absolute position of each cache slot; -1 for not-yet-written slots.
    pos () -> (L,); per-slot pos (B,) -> (B, L)."""
    pos = torch.as_tensor(pos)
    idx = torch.arange(cache_len, device=pos.device)
    if pos.dim() == 1:
        pos = pos[:, None]
    if window is None:
        return torch.where(idx <= pos, idx, -1)
    # ring buffer: slot s holds position p iff p % cache_len == s and
    # pos - cache_len < p <= pos
    cand = pos - (pos % cache_len) + idx
    cand = torch.where(cand > pos, cand - cache_len, cand)
    return torch.where(cand >= 0, cand, -1)


def attend_prefill(params: dict, x: torch.Tensor, cache: dict, pos0: int,
                   cfg, *, window: Optional[int] = None,
                   true_len: Optional[torch.Tensor] = None,
                   paged: Optional[PagedIndex] = None):
    """Prefill one prompt chunk.  x (B, C, d_model) covers absolute
    positions [pos0, pos0 + C), the same for every row (prompts are
    right-padded; ``true_len`` (B,) carries each row's real length so ring
    writes skip padding).

    Writes the chunk's K/V into cache rows [pos0, pos0 + C) (ring wrap for
    window caches) and runs one append-attention call: the chunk's queries
    against the key stream made of the cache prefix and the chunk's own
    K/V.  Returns (out (B, C, d_model), cache).  An int8 cache quantises
    the chunk once: the cache write and the chunk's own part of the key
    stream use the same int8 bytes and scales, so prefill attends to what
    decode later reads back (JAX ``attention.py::attend_prefill``)."""
    if "kp" in cache:
        return _attend_prefill_paged(params, x, cache, pos0, cfg, window,
                                     true_len, paged)
    if "global_len" in cache:
        raise ValueError("prefill writes whole caches: a context-parallel "
                         "engine prefills its group cache and copies each "
                         "rank's columns into its slice")
    b, c, _ = x.shape
    positions = pos0 + torch.arange(c, device=x.device)[None]   # (1, C)
    q, k, v = _qkv(params, x, cfg, *_rope(cfg, positions))
    quant = "ks" in cache
    new = {"k": k, "v": v}
    if quant:
        new["k"], new["ks"] = kv_quant.quantize(k)      # (B,C,Hkv,{D,1})
        new["v"], new["vs"] = kv_quant.quantize(v)
    cache_len = cache["k"].shape[1]

    def stream(prefix: dict) -> dict:
        """Cache prefix + chunk; a float cache's rows in q's dtype, an int8
        one's as stored (the kernel dequantises)."""
        return {n: torch.cat([t if quant else t.to(new[n].dtype), new[n]],
                             dim=1) for n, t in prefix.items()}

    # key stream, taken from the cache as it was before this chunk's write
    # (a ring write below may overwrite rows the stream still needs)
    if pos0 == 0:
        kv_all = new
        kpos_all = torch.arange(c, device=x.device)
        linear = True
    elif window is None:
        kv_all = stream({n: cache[n][:, :pos0] for n in new})
        kpos_all = torch.arange(pos0 + c, device=x.device)
        linear = True
    else:
        kv_all = stream({n: cache[n] for n in new})
        kpos_pre = _cache_positions(
            cache_len, torch.tensor(pos0 - 1, device=x.device), window)
        kpos_all = torch.cat([kpos_pre, positions[0]])
        linear = False

    if window is None:
        if pos0 + c > cache_len:
            # a full cache has no wrap: writing past its end would clobber
            # real prompt rows that kpos still reports as valid
            raise ValueError(
                f"prefill chunk [{pos0}, {pos0 + c}) overflows the "
                f"{cache_len}-slot full cache; chunk the prompt to fit")
        for n, t in new.items():
            cache[n][:, pos0:pos0 + c] = t.to(cache[n].dtype)
    else:
        # ring cache: slot s ends up holding the LAST written position
        # p == s (mod cache_len) with pos0 <= p < end[row], as a per-slot
        # gather (no duplicate-index hazard when C > cache_len; rows stop
        # at their real prompt length)
        end = torch.full((b,), pos0 + c, device=x.device)
        if true_len is not None:
            end = torch.minimum(end, true_len.to(end.device, end.dtype))
        idx = torch.arange(cache_len, device=x.device)
        last = end[:, None] - 1                                 # (B, 1)
        p_cand = last - ((last - idx[None, :]) % cache_len)     # (B, L)
        valid = (p_cand >= pos0)[:, :, None, None]
        sel = (p_cand - pos0).clamp(0, c - 1)[:, :, None, None]
        for n, t in new.items():
            old = cache[n]
            pick = sel.expand((b, cache_len) + old.shape[2:])
            cache[n] = torch.where(valid, torch.gather(t.to(old.dtype), 1,
                                                       pick), old)

    o = dispatch.flash_attention_append(
        q, kv_all["k"], kv_all["v"], kpos_all, pos0=pos0, window=window,
        kpos_linear=linear, k_scale=kv_all.get("ks"),
        v_scale=kv_all.get("vs"))
    n = cfg.n_heads * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, c, n)), cache


def _attend_prefill_paged(params: dict, x: torch.Tensor, cache: dict,
                          pos0: int, cfg, window: Optional[int],
                          true_len: Optional[torch.Tensor],
                          paged: Optional[PagedIndex]):
    """``attend_prefill`` on a paged cache: the key stream is the prefix
    [0, pos0) gathered from the pools before this chunk's write, plus the
    chunk's own K/V (int8: quantised once, the bytes the write lands).
    The writes go where ``prefill_index`` says (``paged``, the chunk's, or
    computed here); rows of one batch that share a page write identical
    values there, and the sink takes its last writer's
    (``_write_pool``)."""
    _check_no_window(window)
    b, c, _ = x.shape
    ps = cache["kp"].shape[1]
    pt = cache["pt"]
    if pos0 + c > pt.shape[1] * ps:
        raise ValueError(
            f"prefill chunk [{pos0}, {pos0 + c}) overflows the "
            f"{pt.shape[1] * ps}-slot paged cache; chunk the prompt to fit")
    idx = paged if paged is not None else \
        prefill_index(pt, ps, pos0, c, true_len)
    positions = pos0 + torch.arange(c, device=x.device)
    q, k, v = _qkv(params, x, cfg, *_rope(cfg, positions[None]))
    new = _new_pool_rows(k, v, "kps" in cache)
    o = dispatch.flash_attention_append_paged(
        q, cache["kp"], cache["vp"], pt, new["kp"], new["vp"], pos0=pos0,
        k_scale=cache.get("kps"), v_scale=cache.get("vps"),
        ks_chunk=new.get("kps"), vs_chunk=new.get("vps"), kpos=idx.kpos,
        rows=idx.rows)
    for name, t in new.items():
        _write_pool(cache, name, idx.page, idx.off, t)
    n = cfg.n_heads * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, c, n)), cache


def attend_verify(params: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor, cfg, *, shift: int,
                  window: Optional[int] = None,
                  paged: Optional[PagedIndex] = None):
    """Score a K-token draft chunk a slot without touching the cache (JAX
    ``attention.py::attend_verify``).  x (B, K, d_model): row j's tokens
    at positions pos[j] + i (rows with a shorter draft carry pad tokens,
    whose keys sit where the causal mask hides them from every valid query
    and whose outputs the caller drops); ``shift`` a static bound on pos
    (the logical cache length).

    The key stream is built as a copy, never in the cache: the cast cache
    (or, paged, its gathered view) followed by the chunk's own K/V, with
    every cache row at or past the slot's pos masked (verify never wrote
    those).  Returns (out (B, K, d_model), pending): ``pending`` holds the
    chunk's K/V rows, an int8 cache's quantised once (the same bytes feed
    this attention and ``commit_kv``), so rejecting a draft needs no KV
    rollback.  ``paged``: the chunk's ``verify_index``."""
    b, kq, _ = x.shape
    positions = pos[:, None] + torch.arange(kq, device=x.device)[None]
    q, k, v = _qkv(params, x, cfg, *_rope(cfg, positions))
    quant = "ks" in cache or "kps" in cache
    pending = {"k": k, "v": v}
    if quant:
        pending["k"], pending["ks"] = kv_quant.quantize(k)  # (B,K,Hkv,{D,1})
        pending["v"], pending["vs"] = kv_quant.quantize(v)
    if "kp" in cache:
        _check_no_window(window)
        pt = cache["pt"]
        idx = paged if paged is not None else \
            verify_index(pt, cache["kp"].shape[1], pos, kq)
        o = dispatch.flash_attention_verify_paged(
            q, cache["kp"], cache["vp"], pt, pending["k"], pending["v"],
            pos=pos, length=pt.shape[1] * cache["kp"].shape[1],
            k_scale=cache.get("kps"), v_scale=cache.get("vps"),
            ks_chunk=pending.get("ks"), vs_chunk=pending.get("vs"),
            kpos=idx.kpos, rows=idx.rows)
    else:
        if "global_len" in cache:
            raise ValueError("speculative verify reads whole caches, not a "
                             "context-parallel slice (see ROADMAP.md, "
                             "queue 3)")
        cache_len = cache["k"].shape[1]
        stream = {n: torch.cat([cache[n] if quant else cache[n].to(q.dtype),
                                pending[n]], dim=1) for n in pending}
        kpos = torch.cat([_cache_positions(cache_len, pos - 1, window),
                          positions], dim=1)
        o = dispatch.flash_attention_verify(
            q, stream["k"], stream["v"], kpos, pos=pos, shift=shift,
            window=window, k_scale=stream.get("ks"),
            v_scale=stream.get("vs"))
    n = cfg.n_heads * cfg.hd
    return cm.linear(params["wo"], o.reshape(b, kq, n)), pending


def commit_kv(cache: dict, pending: dict, pos: torch.Tensor,
              n_acc: torch.Tensor, *, window: Optional[int] = None,
              paged: Optional[PagedIndex] = None) -> dict:
    """Write the accepted prefix of a verify chunk into the cache, in place
    (JAX ``attention.py::commit_kv``): row j writes pending rows
    i < n_acc[j] at positions pos[j] + i (ring: slot p % cache_len; paged:
    through the table, ``paged`` the chunk's ``verify_index``).  One
    scatter a leaf, with no host sync: a paged cache sends rejected and pad
    rows to the page-0 sink; a contiguous one rewrites their slot's current
    value (slot p % cache_len, distinct for the K rows of a slot while
    K <= cache_len; a longer chunk takes one scatter a row)."""
    b, kq = pending["k"].shape[:2]
    dev = pending["k"].device
    positions = pos[:, None].long() + torch.arange(kq, device=dev)
    sel = torch.arange(kq, device=dev)[None, :] < n_acc[:, None]  # (B, K)
    if "kp" in cache:
        idx = paged if paged is not None else verify_index(
            cache["pt"], cache["kp"].shape[1], pos, kq)
        # rejected rows all land on the sink page, each target's last
        # writer defined
        page = torch.where(sel & (idx.page > 0), idx.page, 0)
        for name, leaf in zip(("kp", "vp", "kps", "vps"),
                              ("k", "v", "ks", "vs")):
            if name in cache:
                _write_pool(cache, name, page, idx.off, pending[leaf])
        return cache
    cache_len = cache["k"].shape[1]
    slots = positions % cache_len
    rows = torch.arange(b, device=dev)[:, None].expand(b, kq)
    groups = [slice(None)] if kq <= cache_len else         [slice(i, i + 1) for i in range(kq)]
    for g in groups:
        r, s_, keep = rows[:, g], slots[:, g], sel[:, g]
        for name in kv_leaves(cache):
            leaf = cache[name]
            new = pending[name][:, g].to(leaf.dtype)
            mask = keep.reshape(keep.shape + (1,) * (new.dim() - 2))
            leaf[r, s_] = torch.where(mask, new, leaf[r, s_])
    return cache


# ---------------------------------------------------------------------------
# cross attention (the Whisper decoder)
# ---------------------------------------------------------------------------

def cross_attend(params: dict, x: torch.Tensor, memory_kv: tuple,
                 cfg, tp=None) -> torch.Tensor:
    """x (B, Sq, d); memory_kv = (k, v), each (B, Sm, Hkv, D), from
    ``memory_kv``.  Every query sees every memory row (no mask).  Plain
    products, as the reference's ``sdpa`` (outside any kernel there too):
    f32 scores, an f32 softmax, the probabilities cast to v's dtype for
    the second product.  The head counts are the leaves' and the memory's
    own: under tensor parallelism (``tp``: counted as the ``tp_cross``
    route) this rank's heads, x the whole gathered sequence, and the
    result this rank's partial sum of the output projection."""
    hd = cfg.hd
    n_h, n_kv = params["wq"]["w"].shape[1] // hd, memory_kv[0].shape[2]
    if tp is not None:
        dispatch.count_route("tp_cross")
    b, sq, _ = x.shape
    q = _split_heads(cm.linear(params["wq"], x), n_h, hd)
    k, v = (t.to(q.dtype).repeat_interleave(n_h // n_kv, dim=2)
            for t in memory_kv)
    scores = torch.matmul(q.float().transpose(1, 2),
                          k.float().permute(0, 2, 3, 1)) * hd ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)      # (B, H, Sq, Sm)
    o = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)
    return cm.linear(params["wo"], o.reshape(b, sq, n_h * hd))


def cross_decode(params: dict, x: torch.Tensor, cross: dict, cfg,
                 tp=None) -> torch.Tensor:
    """The Whisper decoder's cross attention at decode, over the cache's
    encoder memory ``cross`` {"k", "v"} (B, Sm, Hkv, D).  Alone it is
    ``cross_attend``.  Under the serving layout (``tp``) q is projected on
    this rank's heads and all-gathered over the model group, the memory
    holds every kv head, and the result is this rank's heads' partial sum
    of ``wo`` (the ``tp_cross`` route).  Where the ``decode_cp`` rules
    split the memory's rows (``cp_layout``: the reference's
    ``cache_shardings`` splits them as a K/V cache's), each shard takes
    f32 scores and the unnormalised (acc, m, l) over its rows, plain
    products as ``cross_attend``'s, and the shards combine as the decode
    kernel's partials do (``dispatch.combine_partials``)."""
    cp = cp_layout(cross)
    if tp is None and cp is None:
        return cross_attend(params, x, (cross["k"], cross["v"]), cfg)
    hd = cfg.hd
    b = x.shape[0]
    q = _split_heads(cm.linear(params["wq"], x),
                     params["wq"]["w"].shape[1] // hd, hd)   # (B, 1, h, D)
    h_loc = q.shape[2]
    if tp is not None:
        dispatch.count_route("tp_cross")
        (q,) = _gather_heads(tp, q)
    n_h = q.shape[2]
    k, v = (t.to(q.dtype).repeat_interleave(n_h // t.shape[2], dim=2)
            for t in (cross["k"], cross["v"]))
    scores = torch.matmul(q.float().transpose(1, 2),
                          k.float().permute(0, 2, 3, 1)) * hd ** -0.5
    if cp is None:
        probs = torch.softmax(scores, dim=-1).to(v.dtype)  # (B, H, 1, Sm)
        o = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)
    else:
        m = scores.amax(dim=-1)                            # (B, H, 1)
        p = torch.exp(scores - m[..., None])
        acc = torch.matmul(p, v.transpose(1, 2).float())  # (B, H, 1, D)
        o = dispatch.combine_partials(acc, m, p.sum(-1), cp.group)
        o = o.to(q.dtype)[:, None]                         # (B, 1, H, D)
    if tp is not None:
        o = o.narrow(2, tp.rank * h_loc, h_loc)
    return cm.linear(params["wo"], o.reshape(b, 1, h_loc * hd))


def memory_kv(params: dict, mem: torch.Tensor, cfg) -> tuple:
    """Cross-attention K/V of the encoder output mem (B, Sm, d), on the
    leaves' kv heads (this rank's under tensor parallelism)."""
    hd = cfg.hd
    n_kv = params["wk"]["w"].shape[1] // hd
    return (_split_heads(cm.linear(params["wk"], mem), n_kv, hd),
            _split_heads(cm.linear(params["wv"], mem), n_kv, hd))
