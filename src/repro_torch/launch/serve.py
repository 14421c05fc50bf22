"""Continuous-batching serve engine (the actor/serving path), contiguous core.

Counterpart of ``repro/launch/serve.py`` on the contiguous KV layout: a
slot table of ``n_slots`` concurrent sequences fed by a queue of requests.

  * **admission** — freed slots take the oldest arrived requests; their
    prompts run together through chunked flash prefill (``n_slots`` rows,
    right-padded to one chunk grid, one append-attention call per layer
    per chunk) and each row is copied into its slot's cache rows;
  * **decode** — every slot steps together through one ``serve_step`` with
    per-slot positions ``pos (B,)``; the decode-attention kernel masks each
    row at its own depth.

KV caches are f32, bf16 or int8 (quantised on write, dequantised inside
the kernels).  ``--decode-cp`` is context-parallel serving: every rank of
the process group (torchrun's ``RANK``/``WORLD_SIZE``, or a group of one)
holds its slice of each slot's cache along the sequence, decode runs the
partials kernel over the slice and combines the ranks with all-reduces.
Admission prefill runs on a whole group cache on every rank (replicated
compute, as the JAX package replicates the weights) and each rank copies
its columns into its slots.  Every rank computes the same logits and so
samples the same tokens; the run checks that they agree.

Reports tokens/s, TTFT and end-to-end latency percentiles, slot occupancy,
the cache layout and the kernel launch counts.

  python -m repro_torch.launch.serve --arch yi-6b --no-reduced \\
      --slots 4 --requests 8 --prompt-range 64,600 --gen-range 16,48 \\
      --cache-len 1024 --kv-dtype bf16 --greedy
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu \\
      --decode-cp --kv-dtype int8 --greedy

``--mode lockstep`` is the wave-batched baseline.  The paged layout,
speculative decoding, fault plans, deadlines and retries are later slices
(ROADMAP.md queue 1) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
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
from repro_torch.launch import traffic
from repro_torch.models import attention as attn
from repro_torch.models import model as M

_LATER = ("see ROADMAP.md, queue 1, slice 3b: paged KV, speculative "
          "decoding and overload handling")


# ---------------------------------------------------------------------------
# request trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    arrival: float                # seconds after engine start
    # robustness knobs of the JAX engine; the port raises if any is set
    deadline_ttft: Optional[float] = None
    deadline_total: Optional[float] = None
    max_retries: int = 0
    # filled by the engine:
    tokens: list = dataclasses.field(default_factory=list)
    t_first: float = -1.0
    t_done: float = -1.0
    eff_arrival: float = -1.0


def _eff_prompt(req: Request) -> np.ndarray:
    """The prompt an admission must prefill: generated-so-far tokens fold
    into it (a requeued request resumes with the logits the uncontended run
    saw)."""
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


def _check_request(r: Request) -> None:
    if r.deadline_ttft is not None or r.deadline_total is not None \
            or r.max_retries:
        raise NotImplementedError(
            f"request {r.rid}: deadlines and retries are not ported yet "
            f"({_LATER})")


def _validate_trace(trace: List[Request], cache_len: int) -> None:
    """A full KV cache has no wrap: reject requests whose decode would run
    past its end (decode writes up to position prompt + max_new - 2)."""
    for r in trace:
        _check_request(r)
        if len(r.prompt) < 1:
            raise ValueError(f"request {r.rid}: empty prompt")
        if len(r.prompt) + r.max_new - 1 > cache_len:
            raise ValueError(
                f"request {r.rid}: prompt {len(r.prompt)} + max_new "
                f"{r.max_new} overruns cache_len {cache_len}; raise "
                "--cache-len (a full cache would wrap and clobber "
                "prompt rows silently)")


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
                     device) -> tuple:
    """Run a right-padded (B, padded) token block through the chunk chain.
    Returns (last_logits (B, V) np.float32, each row's logits at its last
    prompt position, and the cache).  The gather happens on the device, so
    only the (B, V) block crosses to the host; rows with plen 0 keep
    zeros."""
    last = None
    plens = np.asarray(plens)
    true_len = torch.as_tensor(plens, dtype=torch.int32, device=device)
    toks_d = torch.as_tensor(toks, device=device)
    for p0, c in grid:
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
# engine
# ---------------------------------------------------------------------------

class ServeEngine:
    """Slot table + scheduler around one per-slot ``serve_step``.

    The cache holds ``n_slots`` rows per layer; admission prefills the
    arrived group in one batch-``n_slots`` chunk chain on a persistent
    group cache and copies each row into its freed slot.  With
    ``decode_cp`` the slot cache is laid out under ``decode_rules`` over
    the default process group (each rank its slice of the sequence), while
    the group cache stays whole."""

    def __init__(self, cfg, params, *, n_slots: int, cache_len: int,
                 chunk: int = 128, sample: bool = True, seed: int = 0,
                 paged: Optional[bool] = None, kv_dtype="f32",
                 spec: str = "off", fault_plan=None, device=None,
                 decode_cp: bool = False):
        if paged:
            raise NotImplementedError(f"paged KV caches are not ported yet "
                                      f"({_LATER})")
        if spec != "off":
            raise NotImplementedError(f"speculative decoding is not ported "
                                      f"yet ({_LATER})")
        if fault_plan is not None:
            raise NotImplementedError(f"fault plans are not ported yet "
                                      f"({_LATER})")
        if not M.supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"{cfg.name}: recurrent caches have no chunked prefill; "
                "their token-loop admission is not ported yet (see "
                "ROADMAP.md, queue 1, slice 5)")
        self.device = resolve(device)
        self.cfg = cfg
        # cast once: the JAX steps cast inside every call, which in eager
        # PyTorch would copy every weight on every step
        self.params = M.cast_params(cfg, params)
        self.n_slots, self.cache_len, self.chunk = n_slots, cache_len, chunk
        self.sample = sample
        # sampling keys are (request id, logical position) streams off the
        # session key, as the JAX engine's base_key; on the host, where the
        # stream ids and positions are and their hashes are cheap
        self.base_key = prng.key(seed)
        self._t0: Optional[float] = None
        self.serve_step = llm_a3c.make_serve_step(cfg, sample=sample)
        self.prefill_step = llm_a3c.make_prefill_step(cfg)
        self.kv_dtype = kv_quant.resolve_kv_dtype(kv_dtype)
        self.kv_dtype_name = kv_quant.dtype_name(self.kv_dtype)
        self.rules = None
        self.decode_layout = "replicated"
        self.cp_combine_bytes = 0
        if decode_cp:
            if not dist.is_initialized():
                raise ValueError("decode_cp needs a process group: run the "
                                 "engine inside sharding.process_group")
            sharding.check_backend(None, self.device)
            self.rules = sharding.decode_rules(dist.group.WORLD)
            n = self.rules["decode_cp"]["n_shards"]
            # a length that does not divide keeps the cache whole on every
            # rank (the JAX rule); the report says so
            spec, _ = sharding.decode_cp_shard_spec(self.rules["decode_cp"],
                                                    length=cache_len)
            if spec is not None:
                self.decode_layout = f"decode_cp[{n}]"
            self.cp_combine_bytes = traffic.decode_cp_combine_bytes(
                cfg, n_slots, n)
        with ctx.sharding_rules(self.rules):
            self.cache = self._new_cache()
        # persistent admission-prefill cache (batch n_slots), whole on every
        # rank: stale rows beyond a new request's prompt are hidden by the
        # kpos/pos invariant, so it never needs re-zeroing
        self._group_cache = self._new_cache()
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros(n_slots, np.int32)
        self.req_of: List[Optional[Request]] = [None] * n_slots
        self.queue: collections.deque = collections.deque()
        self.reset()

    def _new_cache(self) -> dict:
        """A cache of the engine's shape, laid out under the rules installed
        around the call (whole outside them)."""
        return M.init_cache(self.cfg, self.n_slots, self.cache_len,
                            dtype=self.kv_dtype, device=self.device)

    # -- clock --------------------------------------------------------------

    def start_clock(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since ``start_clock`` (0 before it starts)."""
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

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

    # -- scheduling ---------------------------------------------------------

    def enqueue(self, req: Request) -> None:
        _check_request(req)
        if req.eff_arrival < 0:
            req.eff_arrival = req.arrival
        self.queue.append(req)

    def schedule_admissions(self, now: float) -> List[tuple]:
        """Pair queued, arrived requests with free slots, FIFO."""
        self.queue_depths.append(len(self.queue))
        pairs: List[tuple] = []
        free_slots = [j for j in range(self.n_slots)
                      if self.req_of[j] is None]
        while self.queue and free_slots \
                and self.queue[0].eff_arrival <= now:
            pairs.append((self.queue.popleft(), free_slots.pop(0)))
        return pairs

    # -- admission ----------------------------------------------------------

    def _write_rows(self, group_cache: dict, row_to_slot) -> None:
        """Copy rows of the admission-prefill cache into their slots.  The
        JAX engine finds each cache leaf's batch dimension with eval_shape
        and writes through a jitted masked take; here the batch dimension
        of every contiguous KV leaf is 0, and the rows are written in place
        with ``index_copy_``.  A context-parallel slot cache takes this
        rank's columns of the whole group cache."""
        src = torch.tensor([i for i, _ in row_to_slot], device=self.device)
        dst = torch.tensor([j for _, j in row_to_slot], device=self.device)
        with ctx.sharding_rules(self.rules):
            for big, small in zip(self.cache["layers"],
                                  group_cache["layers"]):
                cp = attn.cp_layout(big)
                cols = slice(None) if cp is None else \
                    slice(cp.start, cp.start + cp.l_loc)
                for name in attn.kv_leaves(big):
                    rows = small[name].index_select(0, src)[:, cols]
                    big[name].index_copy_(0, dst, rows)

    def _prefill_group(self, pairs: List[tuple]):
        """Chunked prefill of up to ``n_slots`` requests in one batched
        chunk chain (rows beyond len(pairs) are dummies).  Returns
        (first_tokens (n_slots,), cache)."""
        prompts = [_eff_prompt(r) for r, _ in pairs]
        toks, plens, grid = _pad_group(prompts, self.n_slots, self.chunk,
                                       self.cache_len)
        last, cache = _chunked_prefill(self.prefill_step, self.params,
                                       self._group_cache, toks, plens, grid,
                                       self.device)
        self._group_cache = cache
        self.prefill_finite &= bool(np.isfinite(last[:len(pairs)]).all())
        # the first token at logical position plen draws from the
        # (rid, plen) stream, like every later decode sample.  (The JAX
        # engine's token-loop admission of recurrent caches keys its prompt
        # by fold_in(base_key, 2**31 + rid); that path comes with the other
        # block kinds, ROADMAP.md queue 1, slice 5.)
        rids = np.zeros(self.n_slots, np.int64)
        for i, (r, _) in enumerate(pairs):
            rids[i] = r.rid
        first = llm_a3c.sample_slot_tokens(
            torch.from_numpy(last), self.base_key, sample=self.sample,
            sids=torch.from_numpy(rids),
            pos=torch.as_tensor(plens, dtype=torch.int64))
        return first.numpy(), cache

    def admit(self, pairs: List[tuple], now: float) -> List[Request]:
        """Admit (request, free slot) pairs with one batched prefill.
        Returns the requests their prefill token already satisfies
        (max_new == 1), which never occupy a slot."""
        t0 = self.now()
        try:
            return self._admit(pairs, now)
        finally:
            self.prefill_wall += self.now() - t0

    def _admit(self, pairs: List[tuple], now: float) -> List[Request]:
        if not pairs:
            return []
        first, cache = self._prefill_group(pairs)
        self._write_rows(cache, [(i, j) for i, (_, j) in enumerate(pairs)])
        finished = []
        for i, (req, j) in enumerate(pairs):
            plen_eff = len(req.prompt) + len(req.tokens)
            self.prefill_tokens += plen_eff
            if req.t_first < 0:
                req.t_first = now
            req.tokens.append(int(first[i]))
            if len(req.tokens) >= req.max_new:
                req.t_done = now
                finished.append(req)
                continue
            self.pos[j] = plen_eff
            self.tok[j] = int(first[i])
            self.req_of[j] = req
        return finished

    # -- decode -------------------------------------------------------------

    def _sids(self) -> torch.Tensor:
        """Per-slot sampling stream ids (request ids; idle rows draw from a
        stream nobody reads), on the host like the positions: the stream
        keys are hashed there."""
        return torch.tensor([r.rid if r is not None else 0
                             for r in self.req_of])

    def decode_step_all(self) -> List[Request]:
        """One per-slot decode step over the whole slot table."""
        now = self.now()
        with ctx.sharding_rules(self.rules):
            tok, _, self.cache = self.serve_step(
                self.params, self.cache,
                {"tokens": torch.as_tensor(self.tok[:, None],
                                           device=self.device)},
                torch.from_numpy(self.pos), self.base_key, self._sids(),
                finite=self._decode_finite)
        tok = tok.cpu().numpy()
        finished = []
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
                self.req_of[j] = None
                self.pos[j] = 0
                self.tok[j] = 0
                finished.append(req)
        self.occupancy.append(float(np.mean([r is not None
                                             for r in self.req_of])))
        return finished

    @property
    def logits_finite(self) -> bool:
        """Every logit the engine produced since the last reset was finite
        (decode steps and the prefill rows that fed first tokens)."""
        return self.prefill_finite and bool(self._decode_finite.item())

    def reset(self) -> None:
        """Clear slot state and counters (caches and built kernels stay)."""
        self.pos[:] = 0
        self.tok[:] = 0
        self.req_of = [None] * self.n_slots
        self.queue.clear()
        self.queue_depths: List[int] = []
        self.prefill_tokens = self.decode_tokens = 0
        self.prefill_wall = 0.0
        self.occupancy: List[float] = []
        self.prefill_finite = True
        self._decode_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)
        self._t0 = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warmup(eng: ServeEngine, trace: List[Request]) -> float:
    """Run, outside the timed region, every prefill chunk offset the trace
    can reach (on a scratch cache), one admission and one decode step:
    builds the kernels at first use and warms the library handles."""
    t0 = time.perf_counter()
    pmax = max((len(r.prompt) for r in trace), default=1)
    toks, plens, grid = _pad_group([np.zeros(pmax, np.int32)], eng.n_slots,
                                   eng.chunk, eng.cache_len)
    _chunked_prefill(eng.prefill_step, eng.params, eng._new_cache(), toks,
                     plens, grid, eng.device)
    warm = Request(rid=-1, prompt=np.zeros(min(8, eng.cache_len - 1),
                                           np.int32), max_new=2, arrival=0.0)
    eng.admit([(warm, 0)], 0.0)
    eng.decode_step_all()
    _sync(eng.device)
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
    return {
        "device": _device_name(eng.device),
        "paged": False,
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
        "queue_depth": _percentiles(eng.queue_depths),
        "chunked_prefill": True,
        "speculative": {"spec": "off"},
        "logits_finite": eng.logits_finite,
        "sample_tokens": first_req.tokens[:4] if first_req else [],
    }


def _drain(eng: ServeEngine, pending: List[Request], qi: int,
           done: List[Request]) -> int:
    """The serve loop: feed arrivals into the queue, admit, decode; when the
    engine idles, sleep until the next arrival.  Runs until ``pending[qi:]``,
    the queue and the slot table are empty; returns the advanced qi."""
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
            time.sleep(max(min(nxt) - eng.now(), 0.0))
            continue
        done.extend(eng.decode_step_all())
    return qi


def run_engine(cfg, params, trace: List[Request], *, n_slots: int,
               cache_len: int, chunk: int, sample: bool, seed: int,
               paged: Optional[bool] = None, kv_dtype="f32",
               device=None, decode_cp: bool = False) -> dict:
    """Continuous batching: arrivals feed the queue, freed slots admit the
    next requests, all slots decode together."""
    eng = ServeEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                      chunk=chunk, sample=sample, seed=seed, paged=paged,
                      kv_dtype=kv_dtype, device=device, decode_cp=decode_cp)
    _validate_trace(trace, cache_len)
    warmup_s = _warmup(eng, trace)
    pending = sorted(trace, key=lambda r: r.arrival)
    done: List[Request] = []
    eng.start_clock()
    _drain(eng, pending, 0, done)
    wall = eng.now()
    return _report("engine", eng, done, wall, warmup_s)


def run_lockstep(cfg, params, trace: List[Request], *, n_slots: int,
                 cache_len: int, chunk: int, sample: bool, seed: int,
                 paged: Optional[bool] = None, kv_dtype="f32",
                 device=None, decode_cp: bool = False) -> dict:
    """Wave-batched baseline: admit ``n_slots`` requests at once (after the
    whole wave has arrived) and decode until the wave's slowest request
    finishes, on the same engine machinery as ``run_engine``."""
    eng = ServeEngine(cfg, params, n_slots=n_slots, cache_len=cache_len,
                      chunk=chunk, sample=sample, seed=seed, paged=paged,
                      kv_dtype=kv_dtype, device=device, decode_cp=decode_cp)
    _validate_trace(trace, cache_len)
    warmup_s = _warmup(eng, trace)
    pending = sorted(trace, key=lambda r: r.arrival)
    waves = [pending[i:i + n_slots]
             for i in range(0, len(pending), n_slots)]
    done: List[Request] = []
    eng.start_clock()
    for wave in waves:
        # the whole wave must have arrived
        time.sleep(max(max(r.arrival for r in wave) - eng.now(), 0.0))
        done.extend(eng.admit(list(zip(wave, range(len(wave)))),
                              eng.now()))
        # finished slots keep burning their decode step until the whole
        # wave drains: the cost the continuous engine removes
        while any(r is not None for r in eng.req_of):
            done.extend(eng.decode_step_all())
    wall = eng.now()
    return _report("lockstep", eng, done, wall, warmup_s)


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
    ap.add_argument("--kv-dtype", default="f32",
                    choices=kv_quant.KV_DTYPES,
                    help="KV cache storage dtype (int8: per-row scales, "
                    "dequantised inside the kernels)")
    ap.add_argument("--decode-cp", action="store_true",
                    help="context-parallel serving: shard each slot's KV "
                    "cache along the sequence over the ranks of the process "
                    "group (torchrun's, or a group of one)")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
    dispatch.reset_launch_counts()
    run = run_engine if args.mode == "engine" else run_lockstep
    kw = dict(n_slots=args.slots, cache_len=cache_len, chunk=args.chunk,
              sample=not args.greedy, seed=args.seed,
              kv_dtype=args.kv_dtype, device=device)
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
                "kernel_launches": dispatch.launch_counts()})
    if rank == 0:
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
