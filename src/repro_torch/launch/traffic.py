"""Traffic and capacity models of the serving path.

Counterpart of ``repro/launch/traffic.py``'s serving share: the bytes a
cache layout holds and a decode step or a chunked prefill moves, the
concurrency a page pool sustains, the combine's bytes of the
context-parallel decode, and the planner's per-card traffic of a step
(``hbm_bytes``, the roofline's memory term).  Cache bytes come from the port's own
``init_cache`` built on the meta device, so layout knowledge lives in one
place: every tensor counted once (the page table all paged layers share
is one tensor).  The JAX cache also carries an int32 ``index`` per layer
and a page table per paged layer; the port's has neither, so its cache
byte counts are below the JAX package's by those few bytes.  The port
keeps mamba2's conv state in f32 (its inputs exactly), where the
reference's cache holds it in the cache dtype, bf16 at the planner's
shapes.  The marginal
bytes of a speculative verify position give the report's wasted bytes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kv_quant
from repro_torch.models import attention
from repro_torch.models import model as M


def _tree_bytes(cache: dict) -> int:
    """Bytes of every tensor of a cache tree (the layers, zamba2's shared
    caches, an encoder-decoder's self and cross caches, the page table),
    each once."""
    tensors = {id(t): t.numel() * t.element_size()
               for t in M.flatten(cache).values()
               if isinstance(t, torch.Tensor)}
    return sum(tensors.values())


def _kv_dtype(kv_dtype) -> torch.dtype:
    return torch.bfloat16 if kv_dtype is None \
        else kv_quant.resolve_kv_dtype(kv_dtype)


def cache_bytes(cfg, batch: int, seq: int, kv_dtype=None) -> int:
    """Bytes of the contiguous serve cache (bf16 K/V by default; int8 adds
    its f32 row scales)."""
    return _tree_bytes(M.init_cache(cfg, batch, seq, dtype=_kv_dtype(kv_dtype),
                                    device="meta"))


def page_pool_bytes(cfg, n_pages: int, page_size: int,
                    kv_dtype=None) -> int:
    """Bytes of the K and V page pools of ``n_pages`` pages over every
    global-attention layer (the only kind the paged layout covers); int8
    adds an f32 scale per pool row and kv head."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    kvd = _kv_dtype(kv_dtype)
    rows = n_pages * page_size * cfg.n_kv_heads
    total = 2 * rows * cfg.hd * kvd.itemsize
    if kv_quant.is_quantized(kvd):
        total += 2 * rows * 4
    return n_attn * total


def paged_cache_bytes(cfg, batch: int, seq: int, *, page_size: int,
                      n_pages: int, kv_dtype=None) -> int:
    """Bytes of the paged serve cache: the pools, the one int32 page table
    and the contiguous ring layers."""
    return _tree_bytes(M.init_cache(
        cfg, batch, seq, dtype=_kv_dtype(kv_dtype), device="meta",
        paged=attention.PagedLayout(page_size, n_pages)))


def paged_capacity(cfg, *, n_slots: int, cache_len: int, page_size: int,
                   resident_tokens_per_req: int, shared_tokens: int = 0,
                   kv_dtype=None) -> dict:
    """Concurrency the paged layout sustains on the bytes the contiguous
    bf16 layout spends on ``n_slots`` full-length slots: each live request
    pays ceil(resident / page_size) pages, of which the leading
    ``shared_tokens // page_size`` whole blocks are shared by all, plus
    its share of the page table and ring layers."""
    budget = cache_bytes(cfg, n_slots, cache_len)
    per_page = page_pool_bytes(cfg, 1, page_size, kv_dtype=kv_dtype)
    per_slot = paged_cache_bytes(cfg, 1, cache_len, page_size=page_size,
                                 n_pages=1, kv_dtype=kv_dtype) - per_page
    shared_pages = shared_tokens // page_size
    req_pages = -(-resident_tokens_per_req // page_size)
    unique = max(req_pages - shared_pages, 1)
    slots_paged = int((budget - shared_pages * per_page)
                      // (unique * per_page + per_slot))
    dedup = (slots_paged * req_pages
             / max(shared_pages + slots_paged * unique, 1))
    return {
        "kv_dtype": kv_quant.dtype_name(_kv_dtype(kv_dtype)),
        "budget_bytes": budget,
        "page_bytes": per_page,
        "per_slot_overhead_bytes": per_slot,
        "shared_pages": shared_pages,
        "unique_pages_per_req": unique,
        "slots_contiguous": n_slots,
        "slots_paged": slots_paged,
        "slot_ratio": slots_paged / max(n_slots, 1),
        "dedup_ratio_model": dedup,
    }


def reservation_capacity(*, n_pages: int, page_size: int,
                         prompt_tokens: int, max_new: int,
                         shared_tokens: int = 0, spec_k: int = 1) -> dict:
    """Concurrency a page pool admits under the engine's two admission
    policies: ``reserve`` holds back each request's worst case,
    ceil((prompt + max_new + spec_k - 1) / page_size) pages, so decode
    never exhausts the pool; ``optimistic`` reserves the prompt's pages
    only and recovers decode-time exhaustion by preempt-and-requeue.
    ``shared_tokens`` leading prompt tokens are shared whole blocks, paid
    once."""
    usable = n_pages - 1                       # page 0 is the sink
    shared_pages = min(shared_tokens, prompt_tokens) // page_size
    worst = -(-(prompt_tokens + max_new + spec_k - 1) // page_size)
    opt = -(-prompt_tokens // page_size)
    worst_u = max(worst - shared_pages, 1)
    opt_u = max(opt - shared_pages, 1)
    slots_reserve = max((usable - shared_pages) // worst_u, 0)
    slots_opt = max((usable - shared_pages) // opt_u, 0)
    return {
        "usable_pages": usable,
        "shared_pages": shared_pages,
        "worst_case_pages_per_req": worst,
        "optimistic_pages_per_req": opt,
        "slots_reserve": slots_reserve,
        "slots_optimistic": slots_opt,
        "overcommit_ratio": slots_opt / max(slots_reserve, 1),
    }


def decode_bytes_per_token(cfg, batch: int, cache_len: int, *,
                           kv_dtype=None, page_size=None,
                           n_pages=None) -> int:
    """Bytes one decode step moves: the bf16 parameters read once and the
    whole cache streamed once (contiguous, or with ``page_size`` the paged
    pool of ``n_pages``)."""
    if page_size is not None:
        cb = paged_cache_bytes(cfg, batch, cache_len, page_size=page_size,
                               n_pages=n_pages or 1, kv_dtype=kv_dtype)
    else:
        cb = cache_bytes(cfg, batch, cache_len, kv_dtype=kv_dtype)
    return 2 * cfg.param_count() + cb


def decode_cp_combine_bytes(cfg, batch: int, n_seq_shards: int) -> int:
    """Bytes per decoded token of the context-parallel combine: every
    attention layer all-reduces three f32 partials, acc (B, Hq, D), m and l
    (B, Hq), across the ``n_seq_shards`` sequence shards.  Whole-group
    total (each shard contributes its copy); the alternative this replaces
    is gathering the KV cache every layer."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "attn_local"))
    per_layer = batch * cfg.n_heads * (cfg.hd + 2) * 4
    return n_attn * per_layer * n_seq_shards


def prefill_attn_bytes(cfg, batch: int, prompt_len: int, chunk_len: int, *,
                       fused: bool) -> int:
    """Bytes of the attention op over a whole chunked prefill, f32
    activations: q and o once, and the key stream (prefix + chunk) written
    once and read once in Hkv layout (``fused``), or for the unfused
    masked-sdpa path read repeated to Hq with an f32 (C, Sk) score tensor
    making five passes."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "attn_local"))
    total = 0
    for p0 in range(0, prompt_len, chunk_len):
        c = min(chunk_len, prompt_len - p0)
        sk = p0 + c
        qo = 2 * batch * c * hq * hd * 4
        if fused:
            kv = 2 * batch * sk * 2 * hkv * hd * 4
            scores = 0
        else:
            kv = 2 * batch * sk * (hkv + 2 * hq) * hd * 4
            scores = 5 * batch * hq * c * sk * 4
        total += n_attn * (qo + kv + scores)
    return total


def prefill_chunk_bytes(cfg, batch: int, prompt_len: int,
                        chunk_len: int) -> int:
    """Bytes of a chunked prefill of (batch, prompt_len) in chunks of
    ``chunk_len``: per chunk a bf16 parameter read, the block in/out
    activations, the chunk's cache rows written, the prefix rows re-read
    and the logits."""
    p = cfg.param_count()
    l, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    row = cache_bytes(cfg, batch, prompt_len) // max(prompt_len, 1)
    total = 0
    for p0 in range(0, prompt_len, chunk_len):
        c = min(chunk_len, prompt_len - p0)
        total += (2 * p + 4 * l * batch * c * d + row * c + row * p0
                  + 4 * batch * c * v)
    return total


def spec_verify_bytes_per_token(cfg) -> int:
    """Marginal bytes that one verify position adds to a speculative round:
    its block in/out activations, its q and o through the append kernel
    and its logits row.  The parameter sweep and the prefix read are paid
    once a round, so a rejected position wastes only this."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "attn_local"))
    acts = 4 * cfg.n_layers * cfg.d_model
    qo = n_attn * 2 * cfg.n_heads * cfg.hd * 4
    return acts + qo + 4 * cfg.vocab_size


def spec_wasted_bytes(cfg, wasted_tokens: int) -> int:
    """Marginal bytes of a run's rejected and over-drafted verify
    positions: ``wasted_tokens * spec_verify_bytes_per_token``."""
    return wasted_tokens * spec_verify_bytes_per_token(cfg)


def hbm_bytes(cfg, shape_id: str, kind: str, n_chips: int) -> float:
    """A card's device-memory traffic of one step of ``kind`` at the
    planner's input shape ``shape_id`` over ``n_chips`` cards, the
    reference's analytic model (``repro/launch/traffic.py::hbm_bytes``:
    every tensor sharded over the whole mesh) on the port's
    ``cache_bytes``: a train step reads the bf16 weights three times and
    the f32 masters, gradients and RMSProp state (30 P), the saved
    residuals (4 L B S d) and the f32 logits' passes (16 B S V); a
    prefill reads the weights once (2 P), writes the activations (4 L B S
    d), the cache and the logits (4 B S V); a decode step reads the bf16
    weights once and the cache.  Like the reference's, the model spreads
    every byte over the chips; the layouts that hold a part on several
    ranks read more than that on those ranks: under the xLSTM head-split
    arm (g ranks a head) the mLSTM's ``n`` and the sLSTM's four states
    are whole on the head's g ranks, g times the reference's bytes of
    them (the planner's memory record counts them, ``sharding.
    cache_shardings``), while the mLSTM's ``C`` takes the reference's."""
    from repro_torch.launch.specs import INPUT_SHAPES
    sh = INPUT_SHAPES[shape_id]
    b, s = sh["batch"], sh["seq"]
    p = cfg.param_count()
    l, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    if kind == "train":
        total = 30 * p + 4 * l * b * s * d + 16 * b * s * v
    elif kind == "prefill":
        total = 2 * p + 4 * l * b * s * d + cache_bytes(cfg, b, s) + \
            4 * b * s * v
    else:
        total = 2 * p + cache_bytes(cfg, b, s)
    return total / n_chips
