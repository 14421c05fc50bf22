"""Continuous-batching serve engine (the actor/serving path).

Counterpart of ``repro/launch/serve.py``: a slot table of ``n_slots``
concurrent sequences fed by a queue of requests.

  * **admission** — freed slots take the oldest arrived requests; their
    prompts run together through chunked flash prefill (``n_slots`` rows,
    right-padded to one chunk grid, one append-attention call per layer
    per chunk); a model whose caches cannot be block-written (recurrent
    states, zamba2's shared block) admits each request through the token
    loop instead, one decode step a prompt token on a single-row cache;
  * **decode** — every slot steps together through one ``serve_step`` with
    per-slot positions ``pos (B,)``; the decode-attention kernel masks each
    row at its own depth.

The KV layout is paged by default, as in the JAX engine: where the model
has global-attention layers and ``cache_len`` is whole pages of
``page_size`` rows, those layers keep their rows in a shared page pool
behind one page table (``models/attention.py``).  A host ``PageAllocator``
hands out refcounted pages (page 0 the sink); a ``PrefixIndex`` maps pages
of a prompt prefix that an earlier request wrote into a new request's
table, whose admission then skips the chunks those pages cover, and a
shared page is copied at its first divergent decode write (copy-on-write).
Admission reserves each request's worst-case pages (``admission=
"reserve"``: decode never exhausts the pool) or its prompt's only
(``"optimistic"``: a decode step that finds the pool empty preempts a slot
and requeues its request, whose tokens so far fold into its next
prefill).  Requests may carry a TTFT deadline (shed at admission, retried
with backoff) and a total deadline (shed mid-decode); a ``FaultPlan``
replays injected allocation failures, forced preemptions, step latencies
and held pages on a virtual clock.  ``paged=False`` keeps the contiguous
layout: one cache row per slot and position, admission rows copied into
their slots.

KV caches are f32, bf16 or int8 (quantised on write, dequantised inside
the kernels).  ``--decode-cp`` is context-parallel serving on the
contiguous layout (a page pool has no sequence slice): every rank of the
process group (torchrun's ``RANK``/``WORLD_SIZE``, or a group of one)
holds its slice of each slot's cache along the sequence, decode runs the
partials kernel over the slice and combines the ranks with all-reduces.
Admission prefill runs on a whole group cache on every rank (replicated
compute, as the JAX package replicates the weights) and each rank copies
its columns into its slots.  Every rank computes the same logits and so
samples the same tokens; the run checks that they agree.

Reports tokens/s, TTFT and end-to-end latency percentiles, slot and page
occupancy, prefix sharing, preemptions, sheds and retries, the cache
layout and the kernel launch counts.

  python -m repro_torch.launch.serve --arch yi-6b --no-reduced \\
      --slots 4 --requests 8 --prompt-range 64,600 --gen-range 16,48 \\
      --cache-len 1024 --kv-dtype bf16 --greedy
  python -m repro_torch.launch.serve --device cpu --greedy \\
      --cache-len 256 --admission optimistic --pages 5
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \\
      --decode-cp --kv-dtype int8 --greedy

``--spec ngram|draft`` is speculative decoding: every decode step becomes
a round that drafts up to ``--spec-k - 1`` tokens a slot (``NgramDraft``
looks them up in the request's own history, ``DraftModel`` runs a small
greedy model), scores each slot's chunk through one fused verify step (the
append kernel at re-based positions, nothing written), accepts the longest
matching draft prefix plus the model's next token, and commits exactly the
accepted rows' KV.  Accepted tokens are plain decode's, sampled ones
included (a token's stream is keyed by its request and position).  Paged
caches map the pages a round may touch before its verify and, under
optimistic admission, unmap those it wholly rejected.  Speculation is not
served with ``--decode-cp`` (ROADMAP.md queue 3).

  python -m repro_torch.launch.serve --device cpu --greedy --spec ngram

``--mode lockstep`` is the wave-batched baseline.
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import logging
import os
import time
import zlib
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import llm_a3c, prng
from repro_torch.device import resolve
from repro_torch.distributed import ctx, sharding
from repro_torch.kernels import dispatch, kv_quant
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import traffic
from repro_torch.models import attention as attn
from repro_torch.models import model as M

SPEC_MODES = ("off", "ngram", "draft")


# ---------------------------------------------------------------------------
# request trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    arrival: float                # seconds after engine start
    # robustness knobs (None = unbounded):
    deadline_ttft: Optional[float] = None   # wait for the first token, from
    #                                         the current (retried) arrival
    deadline_total: Optional[float] = None  # end to end, from the original
    #                                         arrival
    max_retries: int = 0          # re-enqueues after an admission shed (the
    #                               TTFT clock restarts at each)
    # filled by the engine:
    tokens: list = dataclasses.field(default_factory=list)
    t_admit: float = -1.0
    t_first: float = -1.0
    t_done: float = -1.0
    eff_arrival: float = -1.0     # current arrival (moved by retries)
    preemptions: int = 0
    retry_count: int = 0
    shed_reason: Optional[str] = None


def _eff_prompt(req: Request) -> np.ndarray:
    """The prompt an admission must prefill: a preempted request's
    generated-so-far tokens fold into it, so it resumes with the logits the
    uncontended run saw."""
    if req.tokens:
        return np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.tokens, np.int32)])
    return np.asarray(req.prompt, np.int32)


def gen_trace(n_requests: int, *, vocab: int, prompt_range, gen_range,
              arrival_rate: float, seed: int) -> List[Request]:
    """Poisson arrivals (rate <= 0 = all at t=0) with uniform prompt and
    generation lengths; the same numpy draws as the JAX package's
    ``gen_trace``, so both engines serve the same trace."""
    if prompt_range[0] < 1 or gen_range[0] < 1:
        raise ValueError("prompt and generation lengths must be >= 1 "
                         f"(got ranges {prompt_range}, {gen_range})")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        glen = int(rng.integers(gen_range[0], gen_range[1] + 1))
        out.append(Request(
            rid=i, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new=glen, arrival=t))
    return out


def min_accept_margin(cfg, params, trace: List[Request], cache_len: int, *,
                      key: Optional[torch.Tensor] = None,
                      device=None) -> float:
    """Smallest top-2 gap of the scores that chose completed requests'
    tokens, replayed through single-slot decode steps with an f32 cache
    (``repro.launch.serve.min_accept_margin``): the logits of a greedy
    run, or with ``key`` the logits plus the Gumbel noise of each token's
    (rid, position) stream, the scores of a sampled run.  Token identity
    across frameworks or devices holds where this margin is far above the
    ~1e-6 by which their logits differ.  0.0 when a recorded token is not
    the replay's choice.  ``params`` as the engine takes them."""
    dev = resolve(device)
    params = M.cast_params(cfg, params)
    worst = float("inf")
    for r in trace:
        if not r.tokens:
            continue
        seq = [int(t) for t in r.prompt] + [int(t) for t in r.tokens]
        cache = M.init_cache(cfg, 1, cache_len, dtype=torch.float32,
                             device=dev)
        p0 = len(r.prompt)
        for i, t in enumerate(seq[:-1]):
            out, cache = M.decode_step(
                cfg, params, cache,
                {"tokens": torch.tensor([[t]], device=dev)},
                torch.tensor([i], device=dev))
            if i < p0 - 1:
                continue
            row = out["logits"][0, -1].float()
            if key is not None:
                k = llm_a3c.stream_keys(key.to(dev), r.rid, i + 1, 1)
                row = row + prng.gumbel(k[0], row.shape)
            top = torch.topk(row, 2)
            if int(top.indices[0]) != seq[i + 1]:
                return 0.0
            worst = min(worst, float(top.values[0].double()
                                     - top.values[1].double()))
    return worst


def _percentiles(xs) -> dict:
    if not xs:
        return {}
    return {p: round(float(np.percentile(xs, q)), 4)
            for p, q in (("p50", 50), ("p90", 90), ("p99", 99))}


def _validate_trace(trace: List[Request], cache_len: int, *,
                    page_size: Optional[int] = None,
                    usable_pages: Optional[int] = None,
                    spec_k: int = 1) -> None:
    """A full KV cache has no wrap: reject requests whose decode would run
    past its end (decode writes up to position prompt + max_new - 2).  A
    paged engine also rejects a request whose worst-case page demand
    exceeds the pool: it could never be served even alone, and
    preempt-and-requeue would cycle forever.  ``spec_k`` > 1 widens that
    demand by the speculative tail: a verify round maps pages up to
    ``spec_k - 1`` positions past the committed frontier."""
    for r in trace:
        if len(r.prompt) < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if len(r.prompt) + r.max_new - 1 > cache_len:
            raise ValueError(
                f"request {r.rid}: prompt {len(r.prompt)} + max_new "
                f"{r.max_new} overruns cache_len {cache_len}; raise "
                "--cache-len (a full cache would wrap and clobber "
                "prompt rows silently)")
        if page_size:
            need = -(-min(len(r.prompt) + r.max_new + spec_k - 1,
                          cache_len) // page_size)
            if need > usable_pages:
                raise ValueError(
                    f"request {r.rid}: worst-case page demand {need} "
                    f"(ceil((prompt {len(r.prompt)} + max_new {r.max_new}"
                    f" + spec_k {spec_k} - 1) / page_size {page_size})) "
                    f"exceeds the pool's "
                    f"{usable_pages} usable pages — it can never be "
                    "served even alone; raise --pages or shorten the "
                    "request")


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable overload scenario for the serve engine.

    Every field indexes deterministic engine counters, the global
    ``_try_alloc`` call number and the decode step number, so the same plan
    against the same trace replays the same faults:

      * ``fail_alloc_at`` — allocation calls that return None whatever the
                            pool holds (the allocator is untouched, so
                            reservations survive an injected failure);
      * ``preempt_at``    — decode steps that first preempt the victim
                            policy's choice (a repeated index preempts
                            several slots);
      * ``latency_at``    — (step, seconds) added to the engine's virtual
                            clock: with ``clock=lambda: 0.0`` time is wholly
                            virtual and deadlines are deterministic;
      * ``hold_pages``    — pages seized from the pool at init and reset
                            (standing pressure).
    """

    fail_alloc_at: frozenset = frozenset()
    preempt_at: tuple = ()
    latency_at: tuple = ()
    hold_pages: int = 0

    def alloc_fails(self, call: int) -> bool:
        return call in self.fail_alloc_at

    def forced_preempts(self, step: int) -> int:
        return sum(1 for s in self.preempt_at if s == step)

    def step_latency(self, step: int) -> float:
        return sum(lat for s, lat in self.latency_at if s == step)

    @classmethod
    def random(cls, seed: int, *, n_steps: int = 64,
               n_alloc_calls: int = 64, alloc_fail_p: float = 0.1,
               preempt_p: float = 0.05, latency_p: float = 0.1,
               max_latency: float = 0.01,
               hold_pages: int = 0) -> "FaultPlan":
        """The JAX package's draws from ``np.random.default_rng(seed)``: the
        same seed gives the same plan there and here."""
        rng = np.random.default_rng(seed)
        return cls(
            fail_alloc_at=frozenset(
                int(i) for i in range(n_alloc_calls)
                if rng.random() < alloc_fail_p),
            preempt_at=tuple(int(s) for s in range(n_steps)
                             if rng.random() < preempt_p),
            latency_at=tuple(
                (int(s), float(round(rng.uniform(0.0, max_latency), 6)))
                for s in range(n_steps) if rng.random() < latency_p),
            hold_pages=hold_pages)

    def to_json(self) -> str:
        return json.dumps({
            "fail_alloc_at": sorted(self.fail_alloc_at),
            "preempt_at": list(self.preempt_at),
            "latency_at": [list(x) for x in self.latency_at],
            "hold_pages": self.hold_pages})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        return cls(fail_alloc_at=frozenset(d.get("fail_alloc_at", ())),
                   preempt_at=tuple(d.get("preempt_at", ())),
                   latency_at=tuple((int(a), float(b))
                                    for a, b in d.get("latency_at", ())),
                   hold_pages=int(d.get("hold_pages", 0)))


# ---------------------------------------------------------------------------
# chunked prefill plumbing
# ---------------------------------------------------------------------------

def _chunk_grid(pmax: int, chunk: int, cache_len: int) -> List[tuple]:
    """(offset, length) chunks covering the padded prompt grid; the padded
    length is clamped to ``cache_len``, so the last chunk shrinks instead of
    overflowing the cache."""
    if pmax > cache_len:
        raise ValueError(f"prompt length {pmax} exceeds cache_len "
                         f"{cache_len}")
    padded = min(-(-pmax // chunk) * chunk, cache_len)
    grid = []
    p0 = 0
    while p0 < padded:
        grid.append((p0, min(chunk, padded - p0)))
        p0 += grid[-1][1]
    return grid


def _pad_group(prompts: List[np.ndarray], n_rows: int, chunk: int,
               cache_len: int):
    """Right-pad prompt arrays onto the shared chunk grid.  Returns (toks
    (n_rows, padded) int32, plens, grid); rows beyond len(prompts) are
    dummies with plen 0."""
    pmax = max((len(p) for p in prompts), default=1)
    grid = _chunk_grid(pmax, chunk, cache_len)
    padded = grid[-1][0] + grid[-1][1]
    toks = np.zeros((n_rows, padded), np.int32)
    plens = [0] * n_rows
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        plens[i] = len(p)
    return toks, plens, grid


def _chunked_prefill(prefill_step, params, cache, toks, plens, grid,
                     device, skip=()) -> tuple:
    """Run a right-padded (B, padded) token block through the chunk chain.
    Returns (last_logits (B, V) np.float32, each row's logits at its last
    prompt position, and the cache).  The gather happens on the device, so
    only the (B, V) block crosses to the host; rows with plen 0 keep
    zeros.  Chunk offsets in ``skip`` (covered for every row by shared
    prefix pages, and holding no row's last prompt token) are not run."""
    last = None
    plens = np.asarray(plens)
    true_len = torch.as_tensor(plens, dtype=torch.int32, device=device)
    toks_d = torch.as_tensor(toks, device=device)
    for p0, c in grid:
        if p0 in skip:
            continue
        logits, cache = prefill_step(params, cache,
                                     {"tokens": toks_d[:, p0:p0 + c]},
                                     pos0=p0, true_len=true_len)
        if last is None:
            last = torch.zeros((toks.shape[0], logits.shape[-1]),
                               dtype=torch.float32, device=device)
        rel = plens - 1 - p0
        hit = (rel >= 0) & (rel < c)
        if hit.any():
            idx = torch.as_tensor(np.clip(rel, 0, c - 1), device=device)
            rows = logits[torch.arange(len(plens), device=device), idx]
            last = torch.where(torch.as_tensor(hit, device=device)[:, None],
                               rows, last)
    return last.cpu().numpy(), cache


# ---------------------------------------------------------------------------
# page allocator and prefix index (paged KV layout, host side)
# ---------------------------------------------------------------------------

class PageAllocator:
    """Host free-list allocator over the shared page pool.

    Page 0 is the garbage sink (writes through unmapped table entries land
    there; reads mask it through kpos) and is never handed out.  Pages are
    refcounted (prefix sharing maps one page into many slots' tables), and
    ``version`` bumps whenever a page's count returns to 0, so a
    ``PrefixIndex`` entry naming a freed and reissued page fails
    validation instead of aliasing it.

    Exhaustion is a scheduling event: ``try_alloc`` returns None and the
    engine recovers (admission backpressure, preempt-and-requeue).
    ``reserve``/``unreserve`` hold back admitted requests' worst-case
    demand from unreserved allocations, so a reserved allocation never
    fails while ``reserved <= len(free)``."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (sink + 1), got {n_pages}")
        self.n_pages = n_pages
        self.free = list(range(n_pages - 1, 0, -1))      # LIFO, 0 reserved
        self.ref = np.zeros(n_pages, np.int32)
        self.version = np.zeros(n_pages, np.int64)
        self.reserved = 0        # admission units not yet materialised
        self.high_water = 0      # most pages ever in use

    def try_alloc(self, *, reserved: bool = False) -> Optional[int]:
        """A page, or None when the pool cannot serve the call.
        ``reserved=True`` consumes one reservation unit; an unreserved call
        fails once the free list is down to the reserved units."""
        if reserved:
            if self.reserved <= 0:
                raise RuntimeError(
                    "reserved alloc without an outstanding reservation "
                    "(engine reservation accounting is out of sync)")
            if not self.free:
                return None
            self.reserved -= 1
        elif len(self.free) <= self.reserved:
            return None
        p = self.free.pop()
        self.ref[p] = 1
        if self.used_pages > self.high_water:
            self.high_water = self.used_pages
        return p

    def alloc(self) -> int:
        p = self.try_alloc()
        if p is None:
            raise RuntimeError("page pool exhausted; raise --pages")
        return p

    def reserve(self, n: int) -> bool:
        """Set ``n`` pages of future demand aside; False (and no change)
        when the unreserved pool cannot cover them."""
        if n < 0:
            raise ValueError(f"reserve({n})")
        if len(self.free) - self.reserved < n:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self.reserved:
            raise RuntimeError(
                f"unreserve({n}) exceeds outstanding {self.reserved}")
        self.reserved -= n

    def incref(self, p: int) -> None:
        self.ref[p] += 1

    def decref(self, p: int) -> None:
        self.ref[p] -= 1
        if self.ref[p] == 0:
            self.version[p] += 1
            self.free.append(p)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self.free)

    @property
    def free_unreserved(self) -> int:
        return len(self.free) - self.reserved


class PrefixIndex:
    """Prompt-prefix sharing: hash chains over page-sized token blocks.

    Block i keys on ``hash((key_{i-1}, block tokens))``, so a match at
    block i implies the whole prefix matched; lookup stops at the first
    miss.  An entry holds the page, the allocator's version at
    registration and the block's tokens: a hit needs refcount > 0, the same
    version and the same tokens, so recycled pages and hash collisions
    never alias (stale entries are dropped when found).  The final partial
    block registers too and matches only an identical prompt; the two
    copies fork at their first decode write (copy-on-write)."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self.entries: dict = {}          # chain hash -> (page, ver, toks)

    def _blocks(self, prompt):
        h = 0x9E3779B9
        for i in range(0, len(prompt), self.ps):
            blk = tuple(int(t) for t in prompt[i:i + self.ps])
            h = hash((h, blk))
            yield h, blk

    def lookup(self, prompt, alloc: PageAllocator) -> List[tuple]:
        """The longest valid chain of shared pages over the prompt's leading
        blocks: [(page, n_tokens), ...]."""
        out = []
        for h, blk in self._blocks(prompt):
            e = self.entries.get(h)
            if e is None:
                break
            page, ver, toks = e
            if alloc.ref[page] <= 0 or alloc.version[page] != ver \
                    or toks != blk:
                del self.entries[h]      # page recycled since registration
                break
            out.append((page, len(blk)))
        return out

    def register(self, prompt, pages, alloc: PageAllocator) -> None:
        """Record block -> page for every block of the prompt (the first
        writer wins)."""
        for (h, blk), page in zip(self._blocks(prompt), pages):
            if h not in self.entries:
                self.entries[h] = (int(page), int(alloc.version[page]), blk)

    def clear(self) -> None:
        self.entries.clear()


class AllocatorModel:
    """The engine's allocator discipline as a transition system, for the
    small-scope interleaving check of ``tools/audit/alloc_model.explore``,
    which drives real ``PageAllocator``s through every op sequence up to a
    depth.  Each op is one of the engine's allocator interactions:

      * ``alloc``      — unreserved allocation (optimistic admission, decode
                         growth past a consumed reservation), enabled while
                         ``free > reserved``;
      * ``reserve``    — admission sets one page of worst-case demand aside;
      * ``alloc_r``    — a reserved allocation consuming one unit;
      * ``unreserve``  — a finishing, unwinding or preempted slot releases an
                         unmaterialised unit;
      * ``incref(h)``  — a prefix hit maps a held page into another table;
      * ``release(h)`` — a finished slot drops one reference
                         (``ServeEngine._free_slot_pages``);
      * ``cow(h)``     — the first divergent write to a shared page: a
                         private copy, then the shared reference dropped
                         (``ServeEngine._cow_into``);
      * ``preempt(h)`` — preempt-and-requeue: hold ``h`` and every
                         outstanding reservation unit dropped at once;
      * ``spec``       — a verify round maps a page for drafted, not yet
                         verified positions before the accept decision
                         (``ServeEngine._spec_step_all``);
      * ``rewind(h)``  — a speculative page wholly rejected: decref and
                         unmap (optimistic admission's rollback);
      * ``commit(h)``  — an accepted token lands in a speculative page: it
                         becomes an ordinary hold.

    State is ``(allocator, holds)``, ``holds`` the outstanding table
    references as ``(page, version at acquire, kind)`` triples, kind
    ``"c"`` committed or ``"s"`` speculative and awaiting its verdict."""

    def __init__(self, n_pages: int = 4, allocator_cls=None):
        self.n_pages = n_pages
        self.allocator_cls = allocator_cls or PageAllocator

    def initial(self):
        return self.allocator_cls(self.n_pages), ()

    def enabled_ops(self, alloc, holds):
        """Op labels legal in this state (the engine only ever decrefs
        pages it holds)."""
        ops = []
        reserved = int(getattr(alloc, "reserved", 0))
        if len(alloc.free) > reserved:
            ops.append(("alloc",))
            ops.append(("spec",))
        # a refused reserve is backpressure: a no-op state
        ops.append(("reserve",))
        if reserved > 0:
            ops.append(("alloc_r",))
            ops.append(("unreserve",))
        for i, h in enumerate(holds):
            ops.append(("incref", i))
            ops.append(("release", i))
            ops.append(("preempt", i))
            if h[2] == "s":
                # a speculative hold resolves one way a round: wholly
                # rejected (rewind) or touched by an accepted token
                ops.append(("rewind", i))
                ops.append(("commit", i))
            if alloc.ref[h[0]] > 1 and len(alloc.free) > reserved:
                ops.append(("cow", i))
        return ops

    def apply(self, alloc, holds, op):
        """Apply ``op`` to copies of (alloc, holds); returns the new pair."""
        alloc = copy.deepcopy(alloc)
        holds = list(holds)
        kind = op[0]
        if kind in ("alloc", "alloc_r", "spec"):
            p = alloc.try_alloc(reserved=kind == "alloc_r")
            if p is None:
                raise RuntimeError(f"enabled {kind} failed")
            holds.append((p, int(alloc.version[p]),
                          "s" if kind == "spec" else "c"))
        elif kind == "reserve":
            alloc.reserve(1)
        elif kind == "unreserve":
            alloc.unreserve(1)
        elif kind == "incref":
            p = holds[op[1]][0]
            alloc.incref(p)
            holds.append((p, int(alloc.version[p]), "c"))
        elif kind == "release":
            alloc.decref(holds.pop(op[1])[0])
        elif kind in ("rewind", "commit"):
            p, ver, hk = holds[op[1]]
            if hk != "s":
                raise ValueError(f"{kind} of a non-speculative hold")
            if kind == "rewind":
                alloc.decref(holds.pop(op[1])[0])
            else:
                holds[op[1]] = (p, ver, "c")
        elif kind == "cow":
            src, _, hk = holds[op[1]]
            dst = alloc.try_alloc()             # copy rows, then drop the
            if dst is None:                     # shared reference
                raise RuntimeError("enabled cow failed")
            alloc.decref(src)
            holds[op[1]] = (dst, int(alloc.version[dst]), hk)
        elif kind == "preempt":
            alloc.decref(holds.pop(op[1])[0])
            reserved = int(getattr(alloc, "reserved", 0))
            if reserved:
                alloc.unreserve(reserved)
        else:
            raise ValueError(f"unknown op {op!r}")
        return alloc, tuple(sorted(holds))


# ---------------------------------------------------------------------------
# speculative draft sources
# ---------------------------------------------------------------------------

class NgramDraft:
    """Self-drafting by n-gram lookup over a slot's prompt and generated
    tokens ("prompt lookup": no model cost).  ``propose_one(history, k)``
    matches the longest suffix of up to ``n`` tokens against an earlier
    occurrence and proposes the up to ``k - 1`` tokens that followed the
    most recent match with a full continuation (else the most recent
    partial one).  No match, no drafts: the slot rides the verify batch at
    an effective k of 1, one plain decode step."""

    kind = "ngram"

    def __init__(self, n: int = 3):
        self.n = n

    def propose_one(self, hist: List[int], k: int) -> List[int]:
        m = len(hist)
        for n in range(min(self.n, m - 1), 0, -1):
            pat = hist[m - n:]
            best: List[int] = []
            for s in range(m - n - 1, -1, -1):
                if hist[s:s + n] == pat:
                    cont = hist[s + n:s + n + k - 1]
                    if len(cont) == k - 1:
                        return [int(t) for t in cont]
                    if cont and not best:
                        best = [int(t) for t in cont]
            if best:
                return best
        return []

    def admit(self, req: Request, j: int) -> None:
        pass

    def observe(self, js, new_pos) -> None:
        pass

    def reset(self) -> None:
        pass


class DraftModel:
    """A small greedy draft model: ``get_config(arch).reduced()``
    (stablelm-1.6b by default) with the target's vocabulary, so its tokens
    index the logits the verify scores; weights ``init_params(cfg, seed +
    9173)``, the JAX engine's.  It keeps its own f32 contiguous cache, one
    row a slot, and ``dpos[j]``: the cache holds slot j's accepted tokens
    at positions [0, dpos[j]).  ``propose`` first replays accepted tokens
    the cache lacks (at most one in steady state, the bonus token of a
    full accept), then takes ``k - 1`` greedy steps for every slot at
    once; ``observe`` moves dpos to the committed frontier (rows written
    for rejected drafts lie past it, hidden by the decode mask, and are
    overwritten later)."""

    kind = "draft"

    def __init__(self, target_cfg, n_slots: int, cache_len: int,
                 chunk: int, *, arch: Optional[str] = None, seed: int = 0,
                 device=None):
        from repro_torch.configs import get_config

        dcfg = get_config(arch or "stablelm-1.6b").reduced()
        dcfg = dataclasses.replace(dcfg, vocab_size=target_cfg.vocab_size)
        if not M.supports_chunked_prefill(dcfg):
            raise ValueError(f"draft arch {dcfg.name}: no chunked-prefill "
                             "path to admit prompts in blocks")
        self.cfg = dcfg
        self.device = resolve(device)
        self.n_slots, self.cache_len, self.chunk = n_slots, cache_len, chunk
        self.params = M.cast_params(
            dcfg, M.init_params(dcfg, seed + 9173, self.device))
        self.step = llm_a3c.make_serve_step(dcfg, sample=False)
        self.prefill = llm_a3c.make_prefill_step(dcfg)
        self.key = prng.key(seed)                  # greedy: never drawn
        self.cache = self._new_cache(n_slots)
        self.dpos = np.zeros(n_slots, np.int32)
        self._drafted = 0

    def _new_cache(self, batch: int) -> dict:
        return M.init_cache(self.cfg, batch, self.cache_len,
                            dtype=torch.float32, device=self.device)

    def _prefill_row(self, prompt: np.ndarray) -> dict:
        toks, plens, grid = _pad_group([prompt], 1, self.chunk,
                                       self.cache_len)
        return _chunked_prefill(self.prefill, self.params,
                                self._new_cache(1), toks, plens, grid,
                                self.device)[1]

    def warm_prefill(self, plen: int) -> None:
        """Run every chunk offset a ``plen``-token admission reaches (the
        engine's warm-up, outside the timed region)."""
        self._prefill_row(np.zeros(plen, np.int32))

    def admit(self, req: Request, j: int) -> None:
        """Prefill the slot's effective prompt (a preempted request's
        tokens folded in) into draft row ``j``."""
        prompt = _eff_prompt(req)
        small = self._prefill_row(prompt)
        for big, one in zip(self.cache["layers"], small["layers"]):
            for name in attn.kv_leaves(big):
                big[name][j] = one[name][0]
        self.dpos[j] = len(prompt)

    def _step(self, toks: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
        tok, _, self.cache = self.step(self.params, self.cache,
                                       {"tokens": toks},
                                       torch.from_numpy(pos), self.key)
        return tok

    def propose(self, active: np.ndarray, hist, pos: np.ndarray,
                tok: np.ndarray, kmax: int) -> np.ndarray:
        """An (n_slots, kmax - 1) int32 draft matrix.  Rows already in
        step re-feed their last token during catch-up (the same K/V at the
        same position); slots speculating at a smaller k ignore the tail
        columns.  The drafted tokens stay on the device until the last
        step."""
        n = self.n_slots
        while True:
            gap = np.where(active, pos - self.dpos, 0)
            if gap.max() <= 0:
                break
            feed_pos = np.where(gap > 0, self.dpos,
                                np.maximum(self.dpos - 1, 0)).astype(np.int32)
            feed_tok = np.array([hist[j][feed_pos[j]] if active[j] else 0
                                 for j in range(n)], np.int32)
            self._step(torch.as_tensor(feed_tok[:, None], device=self.device),
                       feed_pos)
            self.dpos = np.where(gap > 0, self.dpos + 1,
                                 self.dpos).astype(np.int32)
        drafts = np.zeros((n, max(kmax - 1, 1)), np.int32)
        cur = torch.as_tensor(np.where(active, tok, 0).astype(np.int32)[:, None],
                              device=self.device)
        dp = np.where(active, pos, 0).astype(np.int32)
        cols = []
        for _ in range(kmax - 1):
            cur = self._step(cur, dp)[:, None]
            cols.append(cur)
            dp = dp + 1
        if cols:
            drafts[:, :len(cols)] = torch.cat(cols, dim=1).cpu().numpy()
        self._drafted = kmax - 1
        return drafts

    def observe(self, js, new_pos) -> None:
        """The accept verdict: slot ``j``'s committed frontier moved to
        ``new_pos``.  The drafted rows match the accepted stream as far as
        it reaches, so the draft frontier is min(new_pos, dpos + drafted):
        a full accept leaves the bonus token to the next catch-up."""
        for j, p in zip(js, new_pos):
            self.dpos[j] = min(int(p), int(self.dpos[j]) + self._drafted)

    def reset(self) -> None:
        self.dpos[:] = 0
        for layer in self.cache["layers"]:
            for name in attn.kv_leaves(layer):
                layer[name].zero_()


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Slot table + scheduler around one per-slot ``serve_step``.

    The cache holds ``n_slots`` rows per layer (paged: a page table row per
    slot into the shared pools).  Admission prefills the arrived group in
    one batch-``n_slots`` chunk chain on a group cache: on the paged layout
    its paged layers are the engine's own pools behind the group's page
    table rows, so the prefill writes land in place; contiguous leaves are
    the group's own, and each row is copied into its freed slot.  With
    ``decode_cp`` the slot cache is laid out under ``decode_rules`` over
    the JAX CLI's (data 1, model n) mesh of every rank (each rank its
    slice of the sequence, the weights whole), while the group cache
    stays whole.  With ``spec`` every decode step is a
    speculative round (``_spec_step_all``) of up to ``spec_k`` tokens a
    slot, drafted by ``NgramDraft(draft_ngram)`` or
    ``DraftModel(draft_arch)``."""

    def __init__(self, cfg, params, *, n_slots: int, cache_len: int,
                 chunk: int = 128, sample: bool = True, seed: int = 0,
                 page_size: int = 128, n_pages: int = 0,
                 prefix_cache: bool = True, paged: Optional[bool] = None,
                 kv_dtype="f32", admission: str = "reserve",
                 fault_plan: Optional[FaultPlan] = None, clock=None,
                 retry_backoff: float = 0.05, spec: str = "off",
                 spec_k: int = 4, draft_arch: Optional[str] = None,
                 draft_ngram: int = 3, device=None,
                 decode_cp: bool = False, chunked_prefill: bool = True):
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission policy {admission!r} (want "
                             "'reserve' or 'optimistic')")
        if spec not in SPEC_MODES:
            raise ValueError(f"spec mode {spec!r} (want 'off', 'ngram' or "
                             "'draft')")
        if spec != "off" and decode_cp:
            raise ValueError("speculative decoding is not served with "
                             "decode_cp: a verify over a sequence-split "
                             "cache needs a partials arm of the append "
                             "kernel, which the JAX package lacks too (see "
                             "ROADMAP.md, queue 3)")
        self.device = resolve(device)
        self.cfg = cfg
        # cast once: the JAX steps cast inside every call, which in eager
        # PyTorch would copy every weight on every step
        self.params = M.cast_params(cfg, params)
        self.n_slots, self.cache_len, self.chunk = n_slots, cache_len, chunk
        self.sample = sample
        self.admission = admission
        self.fault_plan = fault_plan
        # time: a custom clock makes time (and so deadlines) virtual, the
        # fault plan's latencies advance it deterministically
        self.clock = clock if clock is not None else time.perf_counter
        self.virtual_time = clock is not None
        self.retry_backoff = retry_backoff
        # sampling keys are (request id, logical position) streams off the
        # session key, as the JAX engine's base_key; on the host, where the
        # stream ids and positions are and their hashes are cheap
        self.base_key = prng.key(seed)
        self.serve_step = llm_a3c.make_serve_step(cfg, sample=sample)
        # None for recurrent, shared-attention and encoder-decoder caches,
        # or when the caller asks for it: those admit through the token
        # loop (_prefill_loop)
        self.prefill_step = llm_a3c.make_prefill_step(cfg) \
            if chunked_prefill else None
        if spec != "off" and self.prefill_step is None:
            raise ValueError(
                f"--spec {spec}: {cfg.name} has no chunked-append path — "
                "recurrent caches can't score a k-token chunk in one "
                "call, so speculation has nothing to verify against")
        # speculative decoding: a draft source, the fused verify + accept +
        # commit step, per-slot adaptive k
        self.spec = spec
        self.spec_k = max(2, int(spec_k)) if spec != "off" else 1
        self.draft_src = None
        if spec == "ngram":
            self.draft_src = NgramDraft(n=draft_ngram)
        elif spec == "draft":
            self.draft_src = DraftModel(cfg, n_slots, cache_len, chunk,
                                        arch=draft_arch, seed=seed,
                                        device=self.device)
        if spec != "off":
            self.verify_step = llm_a3c.make_verify_step(cfg, cache_len,
                                                        sample=sample)
        self.k_of = np.full(n_slots, self.spec_k, np.int32)
        self.accept_ema = np.full(n_slots, 1.0)
        kinds = cfg.layer_kinds()
        self.kv_dtype = kv_quant.resolve_kv_dtype(kv_dtype)
        if kv_quant.is_quantized(self.kv_dtype) and \
                not any(k in M.ATTN_KINDS for k in kinds):
            # the JAX engine's fallback and warning: int8 applies to
            # attention rows only (zamba2's shared block is not a layer
            # kind, so it falls back too)
            logging.warning(
                "--kv-dtype int8 requested but arch %s has no attention "
                "layers (kinds=%s); recurrent state does not quantize — "
                "falling back to f32 cache storage", cfg.name, kinds)
            self.kv_dtype = torch.float32
        self.kv_dtype_name = kv_quant.dtype_name(self.kv_dtype)
        # the JAX engine's default layout (its serve.py:939-943): paged
        # wherever there is a chunked prefill, global-attention layers and
        # whole pages; context-parallel decode splits contiguous caches only
        if paged is None:
            paged = (self.prefill_step is not None and "attn" in kinds
                     and cache_len % page_size == 0 and not decode_cp)
        elif paged and decode_cp:
            raise ValueError("decode_cp splits each slot's cache along the "
                             "sequence and a page pool has no sequence "
                             "slice: serve decode_cp with paged=False")
        elif paged and "attn" not in kinds:
            raise ValueError(f"{cfg.name} has no global-attention layer to "
                             "page")
        elif paged and self.prefill_step is None:
            raise ValueError("the token-loop admission writes contiguous "
                             "caches: serve it with paged=False")
        self.paged = bool(paged)
        self.page_size = page_size
        self.max_pages = cache_len // page_size if self.paged else 0
        # by default the worst case without sharing: every slot fills its
        # table, and the sink
        self.n_pages = (n_pages or n_slots * self.max_pages + 1) \
            if self.paged else 0
        self.prefix_cache = self.paged and bool(prefix_cache)
        if self.paged:
            self.prefix_index = PrefixIndex(page_size)
            self.pt_host = np.full((n_slots, self.max_pages), -1, np.int32)
        self.rules = None
        self.decode_layout = "replicated"
        self.cp_combine_bytes = 0
        if decode_cp:
            if not dist.is_initialized():
                raise ValueError("decode_cp needs a process group: run the "
                                 "engine inside sharding.process_group")
            sharding.check_backend(None, self.device)
            # the JAX CLI's (data 1, model n) mesh over every rank
            self.rules = sharding.decode_rules(
                cfg, mesh_mod.make_mesh((1, dist.get_world_size()),
                                        self.device), batch_size=n_slots)
            n = self.rules["decode_cp"]["n_shards"]
            # a length that does not divide keeps the cache whole on every
            # rank (the JAX rule); the report says so
            spec_, _ = sharding.decode_cp_shard_spec(self.rules["decode_cp"],
                                                     length=cache_len)
            if spec_ is not None:
                self.decode_layout = f"decode_cp[{n}]"
            self.cp_combine_bytes = traffic.decode_cp_combine_bytes(
                cfg, n_slots, n)
        with ctx.sharding_rules(self.rules):
            self.cache = M.init_cache(
                cfg, n_slots, cache_len, dtype=self.kv_dtype,
                device=self.device,
                paged=attn.PagedLayout(page_size, self.n_pages)
                if self.paged else None)
        # the token loop admits into a cache of its own
        self._group_cache = self._new_group_cache() \
            if self.prefill_step is not None else None
        self._staging: dict = {}
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros(n_slots, np.int32)
        self.resv_of = np.zeros(n_slots, np.int32)
        self.req_of: List[Optional[Request]] = [None] * n_slots
        self.queue: collections.deque = collections.deque()
        self.reset()

    def _new_group_cache(self) -> dict:
        """The persistent admission-prefill cache (batch n_slots), whole on
        every rank: stale rows beyond a new request's prompt are hidden by
        the kpos/pos invariant, so it never needs re-zeroing.  Its paged
        layers hold the engine's pools (never copies) behind its own page
        table."""
        if not self.paged:
            return M.init_cache(self.cfg, self.n_slots, self.cache_len,
                                dtype=self.kv_dtype, device=self.device)
        pt = torch.full_like(self.cache["pt"], -1)
        layers = []
        for big in self.cache["layers"]:
            if "kp" in big:
                layers.append({**{n: big[n] for n in attn.pool_leaves(big)},
                               "pt": pt})
            else:
                layers.append(attn.init_kv_cache(
                    self.n_slots, big["k"].shape[1], self.cfg.n_kv_heads,
                    self.cfg.hd, self.kv_dtype, self.device))
        return {"pt": pt, "layers": layers}

    def _upload(self, dst: torch.Tensor, table: np.ndarray) -> None:
        """Host page table -> device table.  On the card through a pinned
        buffer, asynchronously: no host sync, and the buffer is rewritten
        only after its previous copy ran (an event)."""
        if dst.device.type != "cuda":
            dst.copy_(torch.from_numpy(table))
            return
        if id(dst) not in self._staging:
            self._staging[id(dst)] = (
                torch.empty(table.shape, dtype=torch.int32, pin_memory=True),
                torch.cuda.Event())
        buf, done = self._staging[id(dst)]
        done.synchronize()
        buf.numpy()[:] = table
        dst.copy_(buf, non_blocking=True)
        done.record()

    def _push_pt(self) -> None:
        self._upload(self.cache["pt"], self.pt_host)

    # -- clock and fault plumbing --------------------------------------------

    def _apply_fault_pressure(self) -> None:
        """Seize the fault plan's ``hold_pages`` (never the last
        allocatable page)."""
        self._fault_held = []
        if self.paged and self.fault_plan and self.fault_plan.hold_pages:
            n = min(self.fault_plan.hold_pages, len(self.alloc.free) - 1)
            self._fault_held = [self.alloc.alloc() for _ in range(n)]

    @property
    def usable_pages(self) -> int:
        """Pages a request can get: the pool less the sink and the fault
        plan's held pages."""
        return self.n_pages - 1 - len(self._fault_held)

    def start_clock(self) -> None:
        self._t0 = self.clock()
        self._virtual = 0.0

    def now(self) -> float:
        """Seconds since ``start_clock`` plus injected virtual latency (the
        virtual offset alone before the clock starts)."""
        if self._t0 is None:
            return self._virtual
        return self.clock() - self._t0 + self._virtual

    def shared_now(self) -> float:
        """``now()``, the same on every rank of a context-parallel engine
        (the latest rank's clock): every rank then admits the same requests
        at the same step, and their collectives stay paired."""
        now = self.now()
        if self.rules is None or self.rules["decode_cp"]["n_shards"] == 1:
            return now
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.rules["decode_cp"]["group"])
        return float(t.item())

    def advance(self, dt: float) -> None:
        """Wait ``dt`` seconds: a sleep on the real clock, a jump on a
        virtual one."""
        if dt <= 0:
            return
        if self.virtual_time:
            self._virtual += dt
        else:
            time.sleep(dt)

    def _try_alloc(self, *, reserved: bool = False) -> Optional[int]:
        """Every page allocation of the engine: numbers the calls so a
        ``FaultPlan`` can fail chosen ones (the allocator untouched)."""
        i = self._alloc_calls
        self._alloc_calls += 1
        if self.fault_plan is not None and self.fault_plan.alloc_fails(i):
            self.injected_alloc_failures += 1
            return None
        return self.alloc.try_alloc(reserved=reserved)

    # -- scheduling: backpressure, deadlines, preemption ---------------------

    def _need_pages(self, req: Request) -> int:
        """Pages to reserve at admission: the worst case,
        ceil((prompt + max_new + spec_k - 1) / page_size) within the cache,
        under ``reserve`` (a verify round maps pages up to spec_k - 1
        positions past the committed frontier, and under ``reserve`` they
        stay mapped through a rejection); the effective prompt's under
        ``optimistic``."""
        if not self.paged:
            return 0
        total = len(req.prompt) + len(req.tokens) \
            if self.admission == "optimistic" \
            else len(req.prompt) + req.max_new + self.spec_k - 1
        return -(-min(total, self.cache_len) // self.page_size)

    def enqueue(self, req: Request) -> None:
        if req.eff_arrival < 0:
            req.eff_arrival = req.arrival
        self.queue.append(req)

    def _shed_admission(self, req: Request, now: float) -> None:
        """TTFT deadline missed while queued: requeue with exponential
        backoff while retries are left (its TTFT clock restarts at the new
        arrival), else drop."""
        self.sheds_admission += 1
        if req.retry_count < req.max_retries:
            req.retry_count += 1
            self.retries += 1
            req.eff_arrival = now + \
                self.retry_backoff * (2 ** (req.retry_count - 1))
            self.queue.append(req)
        else:
            req.shed_reason = "ttft-deadline"
            req.t_done = now
            self.shed_requests.append(req)

    def schedule_admissions(self, now: float) -> List[tuple]:
        """Pair queued requests with free slots, FIFO.  A paged admission
        first reserves its pages; a head that does not fit blocks the line
        (the pool drains to it).  Entries in retry backoff are skipped;
        TTFT misses shed here, before a prefill is spent on them."""
        self.queue_depths.append(len(self.queue))
        pairs: List[tuple] = []
        free_slots = [j for j in range(self.n_slots)
                      if self.req_of[j] is None]
        i = 0
        while i < len(self.queue) and free_slots:
            req = self.queue[i]
            if req.eff_arrival > now:
                i += 1
                continue
            if req.deadline_ttft is not None and req.t_first < 0 \
                    and now - req.eff_arrival > req.deadline_ttft:
                del self.queue[i]
                self._shed_admission(req, now)
                continue
            need = self._need_pages(req)
            if self.paged and not self.alloc.reserve(need):
                break
            j = free_slots.pop(0)
            self.resv_of[j] = need
            del self.queue[i]
            pairs.append((req, j))
        return pairs

    def _release_reservation(self, j: int) -> None:
        if self.paged and self.resv_of[j]:
            self.alloc.unreserve(int(self.resv_of[j]))
            self.resv_of[j] = 0

    def _slot_alloc(self, j: int) -> Optional[int]:
        """One page for slot ``j``: from its reservation while any is left
        (an injected failure leaves the unit), then unreserved."""
        if self.resv_of[j] > 0:
            p = self._try_alloc(reserved=True)
            if p is not None:
                self.resv_of[j] -= 1
            return p
        return self._try_alloc()

    def _choose_victim(self) -> Optional[int]:
        """Least decode progress first (cheapest re-prefill), then most
        private pages, then the youngest request: the oldest request
        furthest along is never the victim, which keeps the run moving."""
        best, best_key = None, None
        for v in range(self.n_slots):
            req = self.req_of[v]
            if req is None:
                continue
            private = sum(1 for p in self.pt_host[v]
                          if p >= 0 and self.alloc.ref[int(p)] == 1) \
                if self.paged else 0
            k = (len(req.tokens), -private, -req.rid)
            if best_key is None or k < best_key:
                best, best_key = v, k
        return best

    def _vacate(self, j: int) -> None:
        """Slot ``j`` holds no request: its position, token and (paged) its
        pages and reservation go."""
        self.req_of[j] = None
        self.pos[j] = 0
        self.tok[j] = 0
        if self.paged:
            self._free_slot_pages(j)

    def _preempt(self, v: int) -> None:
        """Evict slot ``v`` and requeue its request at the front.  Private
        pages free; shared prefix pages keep their other references and
        their index entries, so the re-admission maps them again and skips
        their chunks; the tokens so far fold into its prefill."""
        req = self.req_of[v]
        self._vacate(v)
        req.preemptions += 1
        self.preemptions += 1
        self.requeues += 1
        self.queue.appendleft(req)

    def _alloc_with_preemption(self, j: int) -> Optional[int]:
        """A decode-time page for slot ``j``: on exhaustion preempt victims
        until the allocation succeeds or ``j`` itself is preempted (None).
        Each failed attempt evicts an active slot, and ``j`` is one."""
        while True:
            p = self._slot_alloc(j)
            if p is not None:
                return p
            v = self._choose_victim()
            if v is None:       # unreachable: j itself is active
                raise RuntimeError(
                    "page pool exhausted with no preemptible slot")
            self._preempt(v)
            if v == j:
                return None

    # -- admission ----------------------------------------------------------

    def _write_rows(self, group_cache: dict, row_to_slot) -> None:
        """Copy rows of an admission cache (the group's, or the token
        loop's single row) into their slots (the JAX engine's jitted
        masked take): the batch dimension of every contiguous KV leaf and
        every recurrent state leaf is 0, and the rows are written in place
        with ``index_copy_``.  Paged layers are skipped: the group's writes
        landed in the engine's pools.  A context-parallel slot cache takes
        this rank's columns of the whole admission cache."""
        src = torch.tensor([i for i, _ in row_to_slot], device=self.device)
        dst = torch.tensor([j for _, j in row_to_slot], device=self.device)
        with ctx.sharding_rules(self.rules):
            for big, small in zip(M.slot_layers(self.cache),
                                  M.slot_layers(group_cache)):
                cp = attn.cp_layout(big)
                cp_leaves = attn.kv_leaves(big) if cp is not None else ()
                for name in M.state_leaves(big):
                    rows = small[name].index_select(0, src)
                    if name in cp_leaves:
                        rows = rows[:, cp.start:cp.start + cp.l_loc]
                    big[name].index_copy_(0, dst, rows)

    def _map_prompt_pages(self, req: Request, j: int) -> Optional[int]:
        """Build an admitted request's page table row: shared prefix pages
        mapped (incref), fresh pages for the rest, and the prompt's blocks
        registered for later admissions, this group's included.  Returns
        the shared coverage in tokens (for chunk skipping), or None when
        the pool ran out part way: every page placed is then unwound, so
        refcounts and ``used_pages`` are as before.  A prefix hit consumes
        a reservation unit too: the page is part of the request's demand.
        Rows of one group that share a page write identical values there;
        the first divergent decode write forks it."""
        prompt = _eff_prompt(req)
        n_p = -(-len(prompt) // self.page_size)
        self.pages_requested += n_p
        row = np.full(self.max_pages, -1, np.int32)
        matched = self.prefix_index.lookup(prompt, self.alloc) \
            if self.prefix_cache else []
        placed: List[int] = []
        cov = 0
        for idx, (page, ntok) in enumerate(matched):
            self.alloc.incref(page)
            if self.resv_of[j] > 0:
                self.alloc.unreserve(1)
                self.resv_of[j] -= 1
            row[idx] = page
            placed.append(page)
            cov += ntok
        for idx in range(len(matched), n_p):
            p = self._slot_alloc(j)
            if p is None:
                for q in placed:
                    self.alloc.decref(int(q))
                self._release_reservation(j)
                self.pages_requested -= n_p
                return None
            row[idx] = p
            placed.append(p)
            self.pages_alloced += 1
        if self.prefix_cache:
            self.prefix_index.register(prompt, row[:n_p], self.alloc)
        self.pt_host[j] = row
        return cov

    def _prefill_group(self, pairs: List[tuple], shared=None):
        """Chunked prefill of up to ``n_slots`` requests in one batched
        chunk chain (rows beyond len(pairs) are dummies).  On the paged
        layout the group's page table takes the admitted slots' rows, and a
        chunk that every row's shared prefix covers, holding no row's last
        prompt token, is skipped: its K/V are in the shared pages.
        Returns (first_tokens (n_slots,), cache)."""
        prompts = [_eff_prompt(r) for r, _ in pairs]
        toks, plens, grid = _pad_group(prompts, self.n_slots, self.chunk,
                                       self.cache_len)
        skip: set = set()
        if self.paged:
            rows = np.full((self.n_slots, self.max_pages), -1, np.int32)
            for i, (_, j) in enumerate(pairs):
                rows[i] = self.pt_host[j]
            self._upload(self._group_cache["pt"], rows)
            # ring layers keep contiguous caches that need every chunk
            if self.prefix_cache and all(
                    k == "attn" for k in self.cfg.layer_kinds()):
                for p0, c in grid:
                    if all(pl <= p0 or (sh >= p0 + c and pl - 1 >= p0 + c)
                           for pl, sh in zip(plens[:len(pairs)], shared)):
                        skip.add(p0)
                self.prefill_chunks_skipped += len(skip)
        last, cache = _chunked_prefill(self.prefill_step, self.params,
                                       self._group_cache, toks, plens, grid,
                                       self.device, skip=skip)
        self._group_cache = cache
        self.prefill_finite &= bool(np.isfinite(last[:len(pairs)]).all())
        # the first token at logical position plen draws from the
        # (rid, plen) stream, like every later decode sample (the token
        # loop, _prefill_loop, keys its prompt otherwise, as the JAX
        # engine's)
        rids = np.zeros(self.n_slots, np.int64)
        for i, (r, _) in enumerate(pairs):
            rids[i] = r.rid
        first = llm_a3c.sample_slot_tokens(
            torch.from_numpy(last), self.base_key, sample=self.sample,
            sids=torch.from_numpy(rids),
            pos=torch.as_tensor(plens, dtype=torch.int64))
        return first.numpy(), cache

    def _prefill_loop(self, req: Request, key: torch.Tensor):
        """Admission of a cache that cannot be block-written (recurrent
        states, zamba2's shared block): one decode step a prompt token on
        a single-row cache of the engine's dtypes, whole on every rank,
        the JAX engine's ``_prefill_loop``.  Token i draws as a lockstep
        step at position i under ``fold_in(key, i)`` (row 0's fold of it),
        ``key`` being fold_in(base_key, 2**31 + rid): not the (rid, pos)
        stream of the chunked admission.  Returns (the first token, the
        cache)."""
        cache = M.init_cache(self.cfg, 1, self.cache_len,
                             dtype=self.kv_dtype, device=self.device)
        prompt = _eff_prompt(req)
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        toks = torch.as_tensor(prompt, device=self.device)
        for i in range(len(prompt)):
            tok, _, cache = self.serve_step(
                self.params, cache, {"tokens": toks[None, i:i + 1]},
                torch.tensor(i), prng.fold_in(key, i), finite=finite)
        self.prefill_finite &= bool(finite.item())
        return int(tok[0]), cache

    def admit(self, pairs: List[tuple], now: float) -> List[Request]:
        """Admit (request, free slot) pairs with one batched prefill.
        Returns the requests their prefill token already satisfies
        (max_new == 1), which never occupy a slot.  A paged request whose
        page mapping runs out of pool is unwound and requeued at the
        front."""
        t0 = self.now()
        try:
            return self._admit(pairs, now)
        finally:
            self.prefill_wall += self.now() - t0

    def _admit(self, pairs: List[tuple], now: float) -> List[Request]:
        if not pairs:
            return []
        shared = None
        if self.paged:
            kept, shared = [], []
            for req, j in pairs:
                cov = self._map_prompt_pages(req, j)
                if cov is None:
                    self.admission_alloc_failures += 1
                    self.requeues += 1
                    req.eff_arrival = min(req.eff_arrival, now) \
                        if req.eff_arrival >= 0 else now
                    self.queue.appendleft(req)
                else:
                    kept.append((req, j))
                    shared.append(cov)
            pairs = kept
            if not pairs:
                return []
        if self.prefill_step is not None:
            first, cache = self._prefill_group(pairs, shared)
            self._write_rows(cache, [(i, j) for i, (_, j)
                                     in enumerate(pairs)])
        else:
            first = []
            for req, j in pairs:
                f, cache = self._prefill_loop(
                    req, prng.fold_in(self.base_key, 2 ** 31 + req.rid))
                self._write_rows(cache, [(0, j)])
                first.append(f)
        finished = []
        for i, (req, j) in enumerate(pairs):
            plen_eff = len(req.prompt) + len(req.tokens)
            self.prefill_tokens += plen_eff
            req.t_admit = now
            if req.t_first < 0:     # TTFT is the first token ever: a
                req.t_first = now   # preempted request keeps its own
            req.tokens.append(int(first[i]))
            if len(req.tokens) >= req.max_new:
                req.t_done = now
                finished.append(req)
                if self.paged:
                    self._free_slot_pages(j)
                continue
            self.pos[j] = plen_eff
            self.tok[j] = int(first[i])
            self.req_of[j] = req
            if self.draft_src is not None:
                # the draft's frontier to the committed stream (a
                # preempted request's tokens are folded in)
                self.draft_src.admit(req, j)
        if self.paged:
            self._push_pt()
        return finished

    # -- decode -------------------------------------------------------------

    def _free_slot_pages(self, j: int) -> None:
        """Drop slot ``j``'s page references and its unmaterialised
        reservation (that headroom goes back to the queue)."""
        for p in self.pt_host[j]:
            if p >= 0:
                self.alloc.decref(int(p))
        self.pt_host[j] = -1
        self._release_reservation(j)

    def _cow_into(self, src: int, dst: int) -> int:
        """Fork a shared page before its first divergent write: its rows
        in every paged layer's pools copied into the private page ``dst``,
        our reference to ``src`` dropped."""
        for layer in self.cache["layers"]:
            for name in attn.pool_leaves(layer):
                layer[name][dst].copy_(layer[name][src])
        self.alloc.decref(src)
        self.cow_events += 1
        self.pages_alloced += 1
        return dst

    def _sids(self) -> torch.Tensor:
        """Per-slot sampling stream ids (request ids; idle rows draw from a
        stream nobody reads), on the host like the positions: the stream
        keys are hashed there."""
        return torch.tensor([r.rid if r is not None else 0
                             for r in self.req_of])

    def _fault_hooks(self) -> float:
        """The fault plan's hooks of this step: its latency on the virtual
        clock, then its forced preemptions.  Returns the step's now()."""
        step = self.step_count
        now = self.now()
        if self.fault_plan is None:
            return now
        lat = self.fault_plan.step_latency(step)
        if lat:
            self._virtual += lat
            now = self.now()
        forced = False
        for _ in range(self.fault_plan.forced_preempts(step)):
            v = self._choose_victim()
            if v is None:
                break
            self._preempt(v)
            self.forced_preemptions += 1
            forced = True
        if forced and self.paged:
            self._push_pt()
        return now

    def _map_pages(self, span: np.ndarray) -> dict:
        """Before a step writes rows [pos, pos + span[j]) of each active
        slot (a decode step 1, a verify round its k_eff): map a page where
        it has none and fork (copy-on-write) a page it shares (only the
        first can be: shared pages hold prompt prefix), through
        ``_alloc_with_preemption``, the slot's reservation first; pool
        exhaustion preempts.  Returns {slot: page indices mapped here},
        what a verify round may roll back."""
        ps = self.page_size
        new_idx: dict = {}
        dirty = False
        for j in range(self.n_slots):
            if self.req_of[j] is None:
                continue
            lo = int(self.pos[j]) // ps
            hi = (int(self.pos[j]) + int(span[j]) - 1) // ps
            for idx in range(lo, hi + 1):
                if self.req_of[j] is None:
                    break                   # evicted as a victim
                page = int(self.pt_host[j, idx])
                if page >= 0 and self.alloc.ref[page] <= 1:
                    continue
                p = self._alloc_with_preemption(j)
                dirty = True
                if p is None:               # j preempted itself
                    break
                if page < 0:
                    self.pt_host[j, idx] = p
                    self.pages_requested += 1
                    self.pages_alloced += 1
                    new_idx.setdefault(j, []).append(idx)
                    continue
                # re-read: a preemption inside the allocation may have
                # un-shared the page
                page = int(self.pt_host[j, idx])
                if page >= 0 and self.alloc.ref[page] > 1:
                    self.pt_host[j, idx] = self._cow_into(page, p)
                else:
                    self.alloc.decref(p)    # no fork needed any more
        if dirty:
            self._push_pt()
        return new_idx

    def _spec_step_all(self) -> List[Request]:
        """One speculative round over the slot table (JAX
        ``serve.py::_spec_step_all``): draft up to k_j - 1 tokens a slot,
        score the (n_slots, spec_k) chunk, accept each slot's longest
        matching draft prefix plus the model's next token and commit
        exactly those rows' KV in one fused step, then roll back the host
        state of what was rejected.

          * contiguous and ring caches: verify writes nothing, so a
            rejection needs no KV rollback; pos advances by the accepted
            rows only and the mask hides the rest;
          * paged: the pages covering [pos, pos + k_j) are mapped before
            the verify (``_map_pages``); a page whose every position was
            rejected is unmapped under ``optimistic`` admission and kept
            under ``reserve`` (its reservation paid for it, and its rows
            stay masked until decode reaches them).  A fork is never
            undone: at least one token commits, the write it was for.

        Adaptive k: a per-slot EMA of the draft accept rate raises k_j
        toward ``spec_k`` on full accepts and lowers it toward 2 on misses.
        Slots without drafts ride the batch at an effective k of 1 (the
        batch is always (n_slots, spec_k))."""
        now = self._fault_hooks()
        kk, n = self.spec_k, self.n_slots
        # -- draft chunks: row j = [tok_j, d_1 .. d_{k-1}] ------------------
        k_eff = np.ones(n, np.int32)
        toks = np.zeros((n, kk), np.int32)
        hist: List[Optional[List[int]]] = [None] * n
        active = np.array([r is not None for r in self.req_of])
        for j in np.flatnonzero(active):
            req = self.req_of[j]
            toks[j, 0] = self.tok[j]
            # k_j clamps to the cache end only, never to the request's
            # budget: verify may range past it (the accept rule clamps),
            # the tail _need_pages and _validate_trace charge for
            k_eff[j] = max(1, min(int(self.k_of[j]),
                                  self.cache_len - int(self.pos[j])))
            hist[j] = [int(t) for t in req.prompt] + req.tokens
        if self.spec == "draft":
            drafts = self.draft_src.propose(active, hist, self.pos,
                                            self.tok, kk)
            toks[:, 1:] = drafts[:, :kk - 1]
        else:
            for j in np.flatnonzero(active):
                if k_eff[j] >= 2:
                    props = self.draft_src.propose_one(hist[j],
                                                       int(k_eff[j]))
                    k_eff[j] = min(int(k_eff[j]), 1 + len(props))
                    toks[j, 1:k_eff[j]] = props[:int(k_eff[j]) - 1]
        new_idx = self._map_pages(k_eff) if self.paged else {}
        # preemptions while mapping may have evicted drafted slots
        active &= np.array([r is not None for r in self.req_of])
        remaining = np.zeros(n, np.int32)
        for j in np.flatnonzero(active):
            req = self.req_of[j]
            remaining[j] = req.max_new - len(req.tokens)
        # -- one fused verify + accept + commit -----------------------------
        # host arrays go in as copies, and targets/n_acc come back (a sync)
        # before the bookkeeping below advances pos in place
        targets, n_acc, self.cache = self.verify_step(
            self.params, self.cache,
            {"tokens": torch.as_tensor(toks, device=self.device)},
            torch.from_numpy(self.pos.copy()), self.base_key, self._sids(),
            torch.from_numpy(k_eff), torch.from_numpy(remaining),
            finite=self._decode_finite)
        targets = targets.cpu().numpy()
        n_acc = n_acc.cpu().numpy()
        for j in np.flatnonzero(active):
            kj, na = int(k_eff[j]), int(n_acc[j])
            self.spec_drafted += kj - 1
            self.spec_drafts_accepted += na - 1
            self.spec_wasted_tokens += kj - na
            self.accepted_k.append(na)
        self.spec_rounds += 1
        # -- paged rollback: unmap wholly rejected pages ---------------------
        if self.paged and self.admission == "optimistic":
            dirty = False
            for j, idxs in new_idx.items():
                if not active[j]:
                    continue
                pos_new = int(self.pos[j]) + int(n_acc[j])
                for idx in idxs:
                    if idx * self.page_size >= pos_new:
                        self.alloc.decref(int(self.pt_host[j, idx]))
                        self.pt_host[j, idx] = -1
                        self.spec_pages_rewound += 1
                        dirty = True
            if dirty:
                self._push_pt()
        # -- tokens, positions, adaptive k, finish and shed -----------------
        finished: List[Request] = []
        freed = False
        obs_j, obs_pos = [], []
        for j in np.flatnonzero(active):
            req = self.req_of[j]
            na = int(n_acc[j])
            req.tokens.extend(int(t) for t in targets[j, :na])
            self.decode_tokens += na
            self.pos[j] += na
            self.tok[j] = int(targets[j, na - 1])
            obs_j.append(j)
            obs_pos.append(int(self.pos[j]))
            if k_eff[j] > 1:
                rate = (na - 1) / (int(k_eff[j]) - 1)
                self.accept_ema[j] = 0.7 * self.accept_ema[j] + 0.3 * rate
                if self.accept_ema[j] > 0.75:
                    self.k_of[j] = min(int(self.k_of[j]) + 1, self.spec_k)
                elif self.accept_ema[j] < 0.35:
                    self.k_of[j] = max(int(self.k_of[j]) - 1, 2)
            if len(req.tokens) >= req.max_new:
                req.t_done = now
                finished.append(req)
            elif req.deadline_total is not None \
                    and now - req.arrival > req.deadline_total:
                req.t_done = now
                req.shed_reason = "total-deadline"
                self.sheds_decode += 1
                self.shed_requests.append(req)
            else:
                continue
            self._vacate(j)
            self.k_of[j] = self.spec_k
            self.accept_ema[j] = 1.0
            freed = True
        if self.spec == "draft":
            self.draft_src.observe(obs_j, obs_pos)
        self.step_count += 1
        if self.paged:
            if freed:
                self._push_pt()
            self.page_occupancy.append(
                self.alloc.used_pages / max(self.n_pages - 1, 1))
        self.occupancy.append(float(np.mean([r is not None
                                             for r in self.req_of])))
        return finished

    def decode_step_all(self) -> List[Request]:
        """One per-slot decode step over the whole slot table (with
        ``spec``, a speculative round).  The fault plan's hooks run first
        (latency on the virtual clock, forced preemptions); paged growth
        and forks may preempt; a request past its total deadline sheds
        after the token in flight lands."""
        if self.spec != "off":
            return self._spec_step_all()
        now = self._fault_hooks()
        if any(r is not None and r.deadline_total is not None
               for r in self.req_of):
            now = self.shared_now()         # sheds agree across ranks
        if self.paged:
            self._map_pages(np.ones(self.n_slots, np.int32))
        with ctx.sharding_rules(self.rules):
            tok, _, self.cache = self.serve_step(
                self.params, self.cache,
                {"tokens": torch.as_tensor(self.tok[:, None],
                                           device=self.device)},
                torch.from_numpy(self.pos), self.base_key, self._sids(),
                finite=self._decode_finite)
        self.step_count += 1
        tok = tok.cpu().numpy()
        finished = []
        freed = False
        for j in range(self.n_slots):
            req = self.req_of[j]
            if req is None:
                continue
            req.tokens.append(int(tok[j]))
            self.decode_tokens += 1
            self.pos[j] += 1
            self.tok[j] = int(tok[j])
            if len(req.tokens) >= req.max_new:
                req.t_done = now
                finished.append(req)
            elif req.deadline_total is not None \
                    and now - req.arrival > req.deadline_total:
                req.t_done = now
                req.shed_reason = "total-deadline"
                self.sheds_decode += 1
                self.shed_requests.append(req)
            else:
                continue
            # free before the next step: a stale table row would let the
            # idle slot's write land in a page handed to someone else
            self._vacate(j)
            freed = True
        if self.paged:
            if freed:
                self._push_pt()
            self.page_occupancy.append(
                self.alloc.used_pages / max(self.n_pages - 1, 1))
        self.occupancy.append(float(np.mean([r is not None
                                             for r in self.req_of])))
        return finished

    @property
    def logits_finite(self) -> bool:
        """Every logit the engine produced since the last reset was finite
        (decode steps and the prefill rows that fed first tokens)."""
        return self.prefill_finite and bool(self._decode_finite.item())

    def reset(self) -> None:
        """Clear slot state, queue and counters (caches and built kernels
        stay).  Paged: a fresh allocator, an empty prefix index, unmapped
        tables (stale pool rows are unreachable once no table names them)
        and the fault plan's held pages seized again."""
        self.pos[:] = 0
        self.tok[:] = 0
        self.resv_of[:] = 0
        self.req_of = [None] * self.n_slots
        self.queue.clear()
        self.shed_requests: List[Request] = []
        self.queue_depths: List[int] = []
        self.step_count = 0
        self.prefill_tokens = self.decode_tokens = 0
        self.prefill_wall = 0.0
        self.occupancy: List[float] = []
        self.page_occupancy: List[float] = []
        self.pages_requested = self.pages_alloced = 0
        self.cow_events = self.prefill_chunks_skipped = 0
        self.preemptions = self.requeues = 0
        self.sheds_admission = self.sheds_decode = self.retries = 0
        self.admission_alloc_failures = 0
        self.injected_alloc_failures = self.forced_preemptions = 0
        self._alloc_calls = 0
        self.prefill_finite = True
        self._decode_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)
        self._t0: Optional[float] = None
        self._virtual = 0.0
        if self.paged:
            self.alloc = PageAllocator(self.n_pages)
            self.prefix_index.clear()
            self.pt_host[:] = -1
            self._push_pt()
        # speculative state: k back to its ceiling, the EMA optimistic,
        # the draft source re-synced to an empty slot table
        self.k_of[:] = self.spec_k
        self.accept_ema[:] = 1.0
        self.spec_rounds = self.spec_drafted = 0
        self.spec_drafts_accepted = self.spec_wasted_tokens = 0
        self.spec_pages_rewound = 0
        self.accepted_k: List[int] = []
        if self.draft_src is not None:
            self.draft_src.reset()
        self._apply_fault_pressure()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warmup(eng: ServeEngine, trace: List[Request]) -> float:
    """Run, outside the timed region, every prefill chunk offset the trace
    can reach, one admission and one decode step: builds the kernels at
    first use and warms the library handles.  The chunks run on a cache of
    their own (a pool of the sink page alone), as the JAX engine's
    warm-up: the engine's pools and group cache keep a fresh engine's
    contents, which idle slots and padding rows read, and under MoE
    capacity those rows take expert slots from the others.  Where
    preemption is possible a re-prefill folds generated tokens in, so the
    offsets reach prompt + max_new - 1.  The fault plan sleeps meanwhile;
    ``reset`` then leaves the allocator, the prefix index and the fault
    plan's held pages as a fresh engine's."""
    t0 = time.perf_counter()
    plan, eng.fault_plan = eng.fault_plan, None
    pmax = max((len(r.prompt) for r in trace), default=1)
    if eng.paged and (plan is not None or eng.admission == "optimistic"
                      or eng.usable_pages < eng.n_slots * eng.max_pages):
        pmax = min(eng.cache_len,
                   max((len(r.prompt) + r.max_new - 1 for r in trace),
                       default=1))
    if eng.prefill_step is not None:
        toks, plens, grid = _pad_group([np.zeros(pmax, np.int32)],
                                       eng.n_slots, eng.chunk, eng.cache_len)
        warm_cache = M.init_cache(
            eng.cfg, eng.n_slots, eng.cache_len, dtype=eng.kv_dtype,
            device=eng.device,
            paged=attn.PagedLayout(eng.page_size, 1) if eng.paged else None)
        _chunked_prefill(eng.prefill_step, eng.params, warm_cache, toks,
                         plens, grid, eng.device)
        del warm_cache
    if eng.spec == "draft":
        # the draft's admissions: single-row prefills over the same grid
        eng.draft_src.warm_prefill(pmax)
    warm = Request(rid=-1, prompt=np.zeros(min(8, eng.cache_len - 1),
                                           np.int32), max_new=2, arrival=0.0)
    eng.admit([(warm, 0)], 0.0)
    eng.decode_step_all()
    _sync(eng.device)
    eng.fault_plan = plan      # before reset: it seizes hold_pages again
    eng.reset()
    return time.perf_counter() - t0


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _ranks_agree(eng: ServeEngine, done: List[Request]) -> bool:
    """Every rank of a context-parallel engine generated the same tokens
    (a fingerprint of all of them, all-reduced MIN and MAX).  Raises if
    not: the ranks see the same all-reduced logits, so a difference is a
    fault, never noise."""
    if eng.rules is None or eng.rules["decode_cp"]["n_shards"] == 1:
        return True
    flat = [t for r in sorted(done, key=lambda r: r.rid)
            for t in [r.rid, len(r.tokens), *r.tokens]]
    fp = zlib.crc32(np.asarray(flat, np.int64).tobytes())
    lo = torch.tensor([fp], dtype=torch.int64, device=eng.device)
    hi = lo.clone()
    group = eng.rules["decode_cp"]["group"]
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if int(lo.item()) != int(hi.item()):
        raise RuntimeError("context-parallel ranks generated different "
                           "tokens")
    return True


def _report(mode: str, eng: ServeEngine, done: List[Request], wall: float,
            warmup_s: float) -> dict:
    lat = [r.t_done - r.arrival for r in done]
    ttft = [r.t_first - r.arrival for r in done]
    total_new = sum(len(r.tokens) for r in done)
    first_req = min(done, key=lambda r: r.rid) if done else None
    paged = {}
    if eng.paged:
        paged = {
            "page_size": eng.page_size,
            "n_pages": eng.n_pages,
            "usable_pages": eng.usable_pages,
            "page_occupancy": round(float(np.mean(eng.page_occupancy)), 3)
            if eng.page_occupancy else 0.0,
            "pages_requested": eng.pages_requested,
            "pages_alloced": eng.pages_alloced,
            "dedup_ratio": round(
                eng.pages_requested / max(eng.pages_alloced, 1), 3),
            "cow_events": eng.cow_events,
            "prefill_chunks_skipped": eng.prefill_chunks_skipped,
            "prefix_cache": eng.prefix_cache,
            "pool_high_water": int(eng.alloc.high_water),
        }
    robustness = {
        "admission_policy": eng.admission,
        "preemptions": eng.preemptions,
        "requeues": eng.requeues,
        "sheds": eng.sheds_admission + eng.sheds_decode,
        "sheds_admission": eng.sheds_admission,
        "sheds_decode": eng.sheds_decode,
        "shed_requests": len(eng.shed_requests),
        "retries": eng.retries,
        "admission_alloc_failures": eng.admission_alloc_failures,
        "queue_depth": _percentiles(eng.queue_depths),
        "fault_plan": eng.fault_plan is not None,
        "injected_alloc_failures": eng.injected_alloc_failures,
        "forced_preemptions": eng.forced_preemptions,
    }
    speculative = {"spec": eng.spec}
    if eng.spec != "off":
        drafted = eng.spec_drafted
        speculative.update({
            "spec_k": eng.spec_k,
            "draft_source": eng.draft_src.kind,
            "rounds": eng.spec_rounds,
            "drafted_tokens": drafted,
            "accepted_draft_tokens": eng.spec_drafts_accepted,
            "accept_rate": round(eng.spec_drafts_accepted / drafted, 3)
            if drafted else 0.0,
            "mean_accepted_k": round(float(np.mean(eng.accepted_k)), 3)
            if eng.accepted_k else 0.0,
            "wasted_tokens": eng.spec_wasted_tokens,
            "wasted_bytes": traffic.spec_wasted_bytes(
                eng.cfg, eng.spec_wasted_tokens),
            "pages_rewound": eng.spec_pages_rewound,
        })
    return {
        "device": _device_name(eng.device),
        "paged": eng.paged, **paged,
        "kv_dtype": eng.kv_dtype_name,
        "decode_layout": eng.decode_layout,
        "cp_combine_bytes_per_token": eng.cp_combine_bytes,
        "ranks_agree": _ranks_agree(eng, done),
        "mode": mode, "slots": eng.n_slots, "requests": len(done),
        "warmup_s": round(warmup_s, 3),
        "wall_s": round(wall, 3),
        "prefill_tokens": eng.prefill_tokens,
        "generated_tokens": total_new,
        "tokens_per_s": round(total_new / wall, 1) if wall else 0.0,
        "prefill_wall_s": round(eng.prefill_wall, 3),
        "decode_tokens_per_s": round(
            total_new / max(wall - eng.prefill_wall, 1e-9), 1)
        if wall else 0.0,
        "latency_s": _percentiles(lat),
        "ttft_s": _percentiles(ttft),
        "occupancy": round(float(np.mean(eng.occupancy)), 3)
        if eng.occupancy else 0.0,
        "chunked_prefill": eng.prefill_step is not None,
        "robustness": robustness,
        "speculative": speculative,
        "logits_finite": eng.logits_finite,
        "sample_tokens": first_req.tokens[:4] if first_req else [],
    }


def _drain(eng: ServeEngine, pending: List[Request], qi: int,
           done: List[Request]) -> int:
    """The serve loop: feed arrivals into the queue, let the scheduler
    admit (backpressure, deadlines, retries), decode; when the engine
    idles, move to the next arrival or backoff expiry.  Runs until
    ``pending[qi:]``, the queue and the slot table are empty; returns the
    advanced qi."""
    while qi < len(pending) or eng.queue \
            or any(r is not None for r in eng.req_of):
        now = eng.shared_now()
        while qi < len(pending) and pending[qi].arrival <= now:
            eng.enqueue(pending[qi])
            qi += 1
        done.extend(eng.admit(eng.schedule_admissions(now), now))
        if not any(r is not None for r in eng.req_of):
            nxt = [r.eff_arrival for r in eng.queue]
            if qi < len(pending):
                nxt.append(pending[qi].arrival)
            if not nxt:
                break
            eng.advance(min(nxt) - eng.now())
            continue
        done.extend(eng.decode_step_all())
    return qi


def _prepare(eng: ServeEngine, trace: List[Request]) -> float:
    """Check the trace against the engine's layout and warm the engine up;
    returns the warm-up's seconds."""
    _validate_trace(trace, eng.cache_len,
                    page_size=eng.page_size if eng.paged else None,
                    usable_pages=eng.usable_pages if eng.paged else None,
                    spec_k=eng.spec_k)
    return _warmup(eng, trace)


def serve_trace(eng: ServeEngine, trace: List[Request]) -> dict:
    """Continuous batching on ``eng``: arrivals feed the queue, the
    scheduler admits under reservation backpressure into freed slots, all
    slots decode together (preempt-and-requeue on pool exhaustion).
    Returns the report; the engine keeps its books for inspection."""
    warmup_s = _prepare(eng, trace)
    pending = sorted(trace, key=lambda r: r.arrival)
    done: List[Request] = []
    eng.start_clock()
    _drain(eng, pending, 0, done)
    return _report("engine", eng, done, eng.now(), warmup_s)


def run_engine(cfg, params, trace: List[Request], **kw) -> dict:
    """``serve_trace`` on a new engine; ``kw`` are ``ServeEngine``'s
    arguments."""
    return serve_trace(ServeEngine(cfg, params, **kw), trace)


def run_lockstep(cfg, params, trace: List[Request], *,
                 chunked_prefill: bool = True, **kw) -> dict:
    """Wave-batched baseline: admit ``n_slots`` requests at once (after the
    whole wave has arrived) and decode until the wave's slowest request
    finishes, on the same engine machinery as ``run_engine``.
    ``chunked_prefill=False`` admits through the token loop, as the JAX
    runner's, on the contiguous layout (the loop writes contiguous
    caches)."""
    eng = ServeEngine(cfg, params, chunked_prefill=chunked_prefill, **kw)
    warmup_s = _prepare(eng, trace)
    pending = sorted(trace, key=lambda r: r.arrival)
    n = eng.n_slots
    done: List[Request] = []
    eng.start_clock()
    for wave in [pending[i:i + n] for i in range(0, len(pending), n)]:
        # the whole wave must have arrived
        eng.advance(max(r.arrival for r in wave) - eng.now())
        done.extend(eng.admit(list(zip(wave, range(len(wave)))),
                              eng.now()))
        # finished slots keep burning their decode step until the whole
        # wave drains: the cost the continuous engine removes
        while any(r is not None for r in eng.req_of):
            done.extend(eng.decode_step_all())
        # an undersized pool may have preempted wave members into the
        # queue: drain them before the next wave
        if eng.queue:
            _drain(eng, [], 0, done)
    return _report("lockstep", eng, done, eng.now(), warmup_s)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _range(s: str):
    lo, hi = s.split(",")
    return int(lo), int(hi)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the 2-layer smoke variant (--no-reduced: full "
                    "width and depth)")
    ap.add_argument("--mode", choices=("engine", "lockstep"),
                    default="engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-range", type=_range, default=(16, 48),
                    help="uniform prompt-length range lo,hi")
    ap.add_argument("--gen-range", type=_range, default=(8, 32),
                    help="uniform generation-length range lo,hi")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals, requests/s (0 = all at t=0)")
    ap.add_argument("--chunk", type=int, default=128,
                    help="prefill chunk length (tokens per append call)")
    ap.add_argument("--cache-len", type=int, default=0,
                    help="KV cache length (0 = max prompt + max gen)")
    ap.add_argument("--page-size", type=int, default=128,
                    help="paged-KV page size in tokens, rounded to the "
                    "nearest 128 multiple as the JAX CLI rounds it (the "
                    "cache is paged when --cache-len is whole pages)")
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = worst case: slots x "
                    "pages a slot + 1 sink page)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="no shared-prefix page reuse (pages stay private "
                    "to their slot)")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=kv_quant.KV_DTYPES,
                    help="KV cache storage dtype (int8: per-row scales, "
                    "dequantised inside the kernels)")
    ap.add_argument("--admission", choices=("reserve", "optimistic"),
                    default="reserve",
                    help="paged admission: 'reserve' holds back each "
                    "request's worst-case pages (decode never exhausts the "
                    "pool); 'optimistic' reserves its prompt's pages only, "
                    "and decode-time exhaustion preempts and requeues")
    ap.add_argument("--deadline-ttft", type=float, default=0.0,
                    help="TTFT deadline in seconds (0 = none): a request "
                    "still queued past it is shed (re-enqueued with "
                    "backoff while --max-retries allows)")
    ap.add_argument("--deadline-total", type=float, default=0.0,
                    help="end-to-end deadline in seconds (0 = none): "
                    "decode past it sheds the request")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="re-enqueues (exponential backoff) of a request "
                    "shed at admission")
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection plan, a JSON string or a path to "
                    "one (FaultPlan: fail_alloc_at, preempt_at, "
                    "latency_at, hold_pages)")
    ap.add_argument("--decode-cp", action="store_true",
                    help="context-parallel serving: shard each slot's KV "
                    "cache along the sequence over the ranks of the process "
                    "group (torchrun's, or a group of one); contiguous "
                    "layout")
    ap.add_argument("--spec", choices=SPEC_MODES, default="off",
                    help="speculative decoding: 'ngram' drafts from each "
                    "request's own history (prompt lookup), 'draft' from a "
                    "small reduced-config draft model; accepted tokens are "
                    "those of --spec off")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="longest verify chunk a slot (the current token "
                    "and up to k-1 drafts); adaptive k lowers it a slot on "
                    "low acceptance")
    ap.add_argument("--draft-arch", default=None,
                    help="--spec draft: the architecture of the reduced "
                    "draft config (default stablelm-1.6b, with the "
                    "target's vocabulary)")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.page_size % 128 != 0:
        rounded = max(128, round(args.page_size / 128) * 128)
        logging.warning("--page-size %d is not a 128 multiple; rounding to "
                        "%d, as the JAX CLI does", args.page_size, rounded)
        args.page_size = rounded

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "vlm" or cfg.is_encdec:
        # the JAX CLI's refusal, word for word
        raise SystemExit(
            f"{cfg.name}: the serve engine drives token-in/token-out LMs; "
            "VLM embeds / encoder-decoder memories have no request-queue "
            "source here (the decode dry-run still lowers those shapes)")
    device = resolve(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        # one card per torchrun rank: NCCL refuses two ranks on one card
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    params = M.init_params(cfg, args.seed, device, M.compute_dtype(cfg))
    cache_len = args.cache_len or (args.prompt_range[1] + args.gen_range[1])
    trace = gen_trace(args.requests, vocab=cfg.vocab_size,
                      prompt_range=args.prompt_range,
                      gen_range=args.gen_range,
                      arrival_rate=args.arrival_rate, seed=args.trace_seed)
    for r in trace:
        r.deadline_ttft = args.deadline_ttft or None
        r.deadline_total = args.deadline_total or None
        r.max_retries = args.max_retries
    fault_plan = None
    if args.fault_plan:
        s = args.fault_plan
        if not s.lstrip().startswith("{"):
            with open(s) as f:
                s = f.read()
        fault_plan = FaultPlan.from_json(s)
    if args.spec != "off" and args.mode != "engine":
        raise SystemExit("--spec needs --mode engine (lockstep is the "
                         "non-speculative baseline)")
    dispatch.reset_launch_counts()
    run = run_engine if args.mode == "engine" else run_lockstep
    kw = dict(n_slots=args.slots, cache_len=cache_len, chunk=args.chunk,
              sample=not args.greedy, seed=args.seed,
              page_size=args.page_size, n_pages=args.pages,
              prefix_cache=not args.no_prefix_cache,
              kv_dtype=args.kv_dtype, device=device)
    if args.mode == "engine":
        kw.update(admission=args.admission, fault_plan=fault_plan,
                  spec=args.spec, spec_k=args.spec_k,
                  draft_arch=args.draft_arch)
    if args.decode_cp:
        with sharding.process_group(device):
            rec = run(cfg, params, trace, decode_cp=True, **kw)
            rank = dist.get_rank()
    else:
        rec = run(cfg, params, trace, **kw)
        rank = 0
    rec.update({"arch": cfg.name,
                "prompt_range": list(args.prompt_range),
                "gen_range": list(args.gen_range),
                "arrival_rate": args.arrival_rate,
                "kernel_launches": dispatch.launch_counts(),
                "verify_routes": dispatch.route_counts()})
    if rank == 0:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
