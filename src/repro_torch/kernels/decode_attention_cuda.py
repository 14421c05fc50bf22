"""Wrapper of the CUDA per-slot decode attention
(``csrc/decode_attention.cu``).

Replaces ``repro/kernels/decode_attention.py::decode_attention_fwd`` and
``::decode_attention_partials``: one kernel body, normalised or as
flash-decoding partials, over f32, bf16 or int8 caches (int8 with
(B, L, Hkv, 1) f32 scales).  A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain versions in ``ref``.

The kernel splits each slot's key range over blocks (``split_plan``) and
reduces the splits' partials in a second launch; the wrapper allocates
their f32 workspace.  One call counts one launch of its arm.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

# kernel launches since the last reset (dispatch.reset_launch_counts), by arm
launches = 0                  # normalised, f32 / bf16 cache
int8_launches = 0             # normalised, int8 cache
partials_launches = 0         # partials, f32 / bf16 cache
partials_int8_launches = 0    # partials, int8 cache

HEAD_DIMS = (64, 128)   # head dims the kernel is instantiated for
MAX_GROUP = 16          # query heads per kv head one block holds
TILE = 64               # keys per tile of the kernel (kBK)
MAX_TILES_PER_SPLIT = 1024  # live-tile flags a block holds (kMaxTiles)
# blocks of the split kernel an SM holds with a bf16 or int8 cache (84 KB
# of shared memory and 256 threads of at most 128 registers each)
BLOCKS_PER_SM = 2


def split_tiles(length: int, n_split: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split) for about ``n_split`` splits of a key
    range of ``length`` rows: whole tiles of ``TILE`` rows, at least one
    and never more splits than tiles, none empty (the last may be
    shorter), and no more than ``MAX_TILES_PER_SPLIT`` tiles a split."""
    tiles = -(-length // TILE)
    per = min(-(-tiles // max(1, min(n_split, tiles))), MAX_TILES_PER_SPLIT)
    return -(-tiles // per), per


def split_plan(b: int, hkv: int, length: int,
               sm_count: int) -> Tuple[int, int]:
    """The kernel's split of the key range, from the shapes alone (so a
    result repeats exactly): enough splits that the (split, kv head, batch
    row) grid fills ``BLOCKS_PER_SM`` blocks on each of ``sm_count`` SMs,
    at most one a tile.  16 splits of one tile at Yi-6B's serving shape
    (B = 4, Hkv = 4, L = 1024) on 132 SMs."""
    return split_tiles(length, -(-BLOCKS_PER_SM * sm_count // (b * hkv)))


def _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale,
           n_split) -> None:
    build.require(q.dim() == 3 and k_cache.dim() == 4, what,
                  f"want q (B,Hq,D) and caches (B,L,Hkv,D), got "
                  f"{tuple(q.shape)} / {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    _, length, hkv, dk = k_cache.shape
    build.require(k_cache.shape[0] == b and dk == d, what,
                  f"cache {tuple(k_cache.shape)} does not match q "
                  f"{tuple(q.shape)}")
    build.require(v_cache.shape == k_cache.shape, what,
                  "k and v caches differ in shape")
    build.require(hq % hkv == 0, what,
                  f"GQA needs q heads to be a multiple of kv heads, got "
                  f"{hq}/{hkv}")
    build.require(tuple(kpos.shape) == (b, length) and
                  tuple(pos.shape) == (b,), what,
                  f"want kpos (B,L) and pos (B,), got {tuple(kpos.shape)} "
                  f"/ {tuple(pos.shape)}")
    build.require(q.dtype in build.DTYPE_CODE and
                  k_cache.dtype in build.KV_DTYPE_CODE and
                  v_cache.dtype == k_cache.dtype, what,
                  f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}"
                  " (want q float32 or bfloat16, caches float32, bfloat16 or "
                  "int8, k and v alike)")
    quant = k_cache.dtype == torch.int8
    build.require((k_scale is not None) == quant and
                  (v_scale is not None) == quant, what,
                  "int8 caches need k_scale and v_scale, float caches take "
                  "none")
    scales = ()
    if quant:
        build.require(k_scale.shape == (b, length, hkv, 1) and
                      v_scale.shape == k_scale.shape and
                      k_scale.dtype == torch.float32 and
                      v_scale.dtype == torch.float32, what,
                      f"want f32 scales {(b, length, hkv, 1)}, got "
                      f"{tuple(k_scale.shape)} {k_scale.dtype} / "
                      f"{tuple(v_scale.shape)} {v_scale.dtype}")
        scales = (k_scale, v_scale)
    build.require(kpos.dtype == torch.int32 and pos.dtype == torch.int32,
                  what, "kpos and pos must be int32")
    build.require(n_split is None or n_split >= 1, what,
                  f"n_split={n_split} (want >= 1, or None for split_plan)")
    tensors = (q, k_cache, v_cache, kpos, pos) + scales
    build.require(len({t.device for t in tensors}) == 1, what,
                  "inputs on different devices")
    if q.device.type == "cpu":
        return
    build.require(q.is_cuda, what, f"unsupported device {q.device}")
    build.require(d in HEAD_DIMS, what, f"head dim {d} not in {HEAD_DIMS}")
    build.require(hq // hkv <= MAX_GROUP, what,
                  f"{hq // hkv} query heads per kv head (max {MAX_GROUP})")
    build.require(all(t.is_contiguous() for t in tensors), what,
                  "inputs must be contiguous")
    build.require(all(t.data_ptr() % 16 == 0
                      for t in (q, k_cache, v_cache)), what,
                  "q, k and v must start on 16-byte boundaries (the kernel "
                  "loads 16 bytes at a time)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(entry, q, k_cache, v_cache, kpos, pos, k_scale, v_scale,
            outputs, n_split):
    """Plan the split, allocate the splits' f32 workspace and launch
    ``entry`` (the normalised or the partials C entry) with ``outputs``."""
    b, hq, d = q.shape
    _, length, hkv, _ = k_cache.shape
    g = hq // hkv
    if n_split is None:
        n, per = split_plan(b, hkv, length, build.sm_count(q.device.index or 0))
    else:
        n, per = split_tiles(length, n_split)
    # acc (B, Hkv, n, G, D), then m and l (B, Hkv, n, G): one allocation
    rows = b * hkv * n * g
    ws = torch.empty(rows * (d + 2), dtype=torch.float32, device=q.device)
    wacc = ws.data_ptr()
    wm = wacc + rows * d * 4
    return entry(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), kpos.data_ptr(), pos.data_ptr(),
        *[t.data_ptr() for t in outputs], wacc, wm, wm + rows * 4, b,
        length, hq, hkv, d, n, per,
        build.DTYPE_CODE[q.dtype], build.KV_DTYPE_CODE[k_cache.dtype],
        build.stream_of(q))


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kpos: torch.Tensor,
                         pos: torch.Tensor, k_scale=None, v_scale=None, *,
                         n_split: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D); caches (B,L,Hkv,D); kpos (B,L) int32; pos (B,) int32 ->
    (B,Hq,D) in q's dtype.  q may be f32 or bf16, the caches f32, bf16 or
    int8 with (B,L,Hkv,1) f32 ``k_scale``/``v_scale``.  ``n_split``
    overrides ``split_plan`` (through ``split_tiles``) on the card."""
    what = "decode_attention_fwd"
    _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale, n_split)
    if q.device.type == "cpu":
        if k_scale is not None:
            return ref.decode_attention_quant_ref(q, k_cache, v_cache,
                                                  k_scale, v_scale, kpos, pos)
        return ref.decode_attention_ref(q, k_cache, v_cache, kpos, pos)
    out = torch.empty_like(q)
    rc = _launch(build.library().rt_decode_attention_fwd, q, k_cache,
                 v_cache, kpos, pos, k_scale, v_scale, (out,), n_split)
    build.check(rc, what)
    global launches, int8_launches
    if k_scale is None:
        launches += 1
    else:
        int8_launches += 1
    return out


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, kpos: torch.Tensor,
                              pos: torch.Tensor, k_scale=None, v_scale=None,
                              *, n_split: Optional[int] = None):
    """The inputs of ``decode_attention_fwd`` over a (local) cache slice ->
    its unnormalised online-softmax state (acc (B,Hkv,G,D), m (B,Hkv,G),
    l (B,Hkv,G)), all f32; ``ref.combine_partials`` (or the collective
    combine in ``dispatch``) turns slices into the attention output."""
    what = "decode_attention_partials"
    _check(what, q, k_cache, v_cache, kpos, pos, k_scale, v_scale, n_split)
    if q.device.type == "cpu":
        return ref.decode_attention_partials_ref(q, k_cache, v_cache, kpos,
                                                 pos, k_scale, v_scale)
    b, hq, d = q.shape
    _, length, hkv, _ = k_cache.shape
    g = hq // hkv
    acc = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    rc = _launch(build.library().rt_decode_attention_partials, q, k_cache,
                 v_cache, kpos, pos, k_scale, v_scale, (acc, m, l), n_split)
    build.check(rc, what)
    global partials_launches, partials_int8_launches
    if k_scale is None:
        partials_launches += 1
    else:
        partials_int8_launches += 1
    return acc, m, l
