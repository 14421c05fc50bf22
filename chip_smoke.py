#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
     source, all started together, sm_90a) and print each kernel's
     registers, spills and stack from ptxas;
  3. hold each kernel to its plain PyTorch version on the card: the
     serving kernels at the serving shapes of Yi-6B and at edge cases
     (ragged per-slot pos, pos 0, a fully masked row, pos0 in {0, 512}, a
     sliding window, a ring layout, ragged tiles), with f32/bf16 and with
     int8 caches (per-row f32 scales); the partials kernel over 1, 2 and 4
     slices of the serving cache (B = 4, L = 1024, 32 q over 4 kv heads,
     D = 128; bf16, f32 and int8; a fully masked slice, an all-masked
     row, and a ragged L = 300), each slice against the plain partials and
     the slices combined (``ref.combine_partials``) against the decode
     kernel and the plain decode; the training kernels at the train shape (B = 4,
     S = 1024, 32 q heads over 4 kv heads, D = 128, x (4096, 4096), a
     45M-element leaf) and at edge cases (f32, a window, causal=False, a
     ragged S, G = 1, ragged row and element counts; the flash kernels'
     bf16 tensor-core arms also at a ragged S with D = 64 and at a window
     of 16 keys).  f32 within rtol =
     atol = 1e-5; bf16 within two bf16 ulps (rtol = 2**-6) and atol = 1e-5;
     sums over rows or keys (dscale, dq, dk, dv, the partials' acc) with an
     added atol of 2**-14 times the same sum taken over absolute values
     (the f32 summation-order bound, see SUM_ABS_TOL); the bf16 flash arms,
     which round p and ds to bf16 as the TPU kernels do, with a further
     ref.ROUND_TOL (2**-8) times the sum over absolute terms of what they
     round (ref.flash_round_scale), lse held to 1e-5; the rmsnorm wrapper
     must refuse rows it cannot move in 16-byte chunks;
  4. time each kernel and arm, its plain version and the nearest single
     PyTorch call (none for rmsprop, the partials kernel and the int8 arms:
     no PyTorch call computes them) with CUDA events (median, L2 flushed
     before each call) beside the least time the card could take for the
     work, and the ratios of the kernel's time to both (x_bound,
     x_library);
  5. the port's model on a small input on the card against the same model
     on the CPU, then ``run_engine`` on Yi-6B at full width and depth (bf16
     weights from a seed, bf16 KV, 4 slots, cache 1024, chunk 128, 8 greedy
     requests): every request completes, all logits are finite, and the
     run launched the rmsnorm, the append kernel's and the decode
     kernel's bf16 arms and no other attention arm;
  6. a torch.profiler trace of one admission and of eight decode steps of
     that engine: wall time, device busy share and the top kernels;
  6a. the same trace with int8 KV (replicated): the int8 arms of the
     append and decode kernels, and no other attention arm;
  6b. the context-parallel path: the same trace through ``run_engine``
     with int8 KV and ``decode_cp[1]`` over a one-rank NCCL group (a
     ``file://`` store): its report says ``decode_cp[1]``, and it launched
     the int8 append arm and the partials kernel's int8 arm and no other
     attention arm (kernel 6 in neither arm); then its profile as in
     phase 6;
  6c. reduced Yi-6B on the card, greedy: the engine under ``decode_cp[1]``
     emits the tokens of the engine without it, with int8 and bf16 KV;
     each of the four runs checked for its layout and kernels as above;
  7. three train steps of reduced Yi-6B in f32 on the card against the
     same steps on the CPU (losses to rtol 1e-4, parameters to 1e-5),
     through the flash kernels' f32 (SIMT) arms and never their bf16 arms;
  8. Yi-6B at full width cut to 16 of 32 layers (f32 masters, bf16
     compute, remat, shared RMSProp, TokenPipeline batch 4 x 1024): one
     warm-up step, three timed steps and one profiled step; every loss and
     gradient finite, every parameter leaf changed and every training
     kernel launched, the flash kernels through their bf16 (tensor-core)
     arms only: 2 forward launches (the forward and its remat) and one
     backward a layer and step.

Every kernel and arm must have been launched on one of the main paths
(phases 5, 6a, 6b, each of the four runs of 6c, 7 and 8, each with the
counters set to 0 just before it and read just after); the kernels line
gives each one's launches by path.
The last three lines are the card's name and power limit (nvidia-smi), a
JSON object with one record per kernel and {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (rtol, atol).  Kernel and plain version both compute in f32 and round
# once to the output dtype, so a bf16 output may sit one ulp off its plain
# version where the two f32 values straddle a rounding boundary; rtol =
# 2**-6 allows two ulps (a bf16 ulp is at most 2**-7 of the value), and the
# small atol keeps near-zero attention outputs held as tightly.
F32_TOL = (1e-5, 1e-5)
BF16_TOL = (2.0 ** -6, 1e-5)
# An output that is a long f32 sum (dscale over 4096 rows; dq, dk, dv over
# up to 1024 keys or 8 heads x 1024 queries, each term itself a product of
# sums over D = 128) is summed in another order by the kernel than by its
# plain version.  The rounding error of such a nested sum is bounded by
# about (depth of the sums) * u * (the same sums over absolute values),
# u = 2**-24 the f32 unit roundoff; 2**-14 = 1024 u covers the depth with
# room to spare and is still 100x below a bf16 ulp of that magnitude.
SUM_ABS_TOL = 2.0 ** -14
# The bf16 arms of the flash kernels round p and ds to bf16 before their
# products, as the TPU kernels do, while the plain versions keep them in
# f32: each such output may move by ref.ROUND_TOL (2**-8, twice the bf16
# unit roundoff 2**-9) times the same sum over absolute terms
# (ref.flash_round_scale), added to its tolerance.  lse is never rounded.
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TRIALS = 25


def _tol(dtype):
    import torch
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def _compare(what, got, want, sum_abs=None, round_abs=None):
    """Max abs error of got vs want; raises where any element is beyond
    atol + rtol * |want| for the output's dtype.  ``sum_abs``, for an
    output that is a sum (over rows, keys or heads), is the same sum taken
    over the absolute values of its terms: SUM_ABS_TOL * sum_abs is added
    to each element's tolerance (see SUM_ABS_TOL).  ``round_abs``, for an
    output of a bf16 flash arm, is the sum over absolute terms whose
    factors that arm rounds to bf16: ROUND_TOL * round_abs is added too."""
    import torch

    from repro_torch.kernels.ref import ROUND_TOL
    rtol, atol = _tol(want.dtype)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    err = float(diff.max())
    tol = atol + rtol * want.abs()
    if sum_abs is not None:
        tol = tol + SUM_ABS_TOL * sum_abs.float()
    if round_abs is not None:
        tol = tol + ROUND_TOL * round_abs.float()
    # worst element's share of its own tolerance (<= 1 passes)
    use = float((diff / tol).max())
    ok = use <= 1.0
    rms = float(want.square().mean().sqrt())
    extra = f" +{SUM_ABS_TOL:g}*sum|terms|" if sum_abs is not None else ""
    if round_abs is not None:
        extra += f" +{ROUND_TOL:g}*sum|rounded terms|"
    print(f"check {what}: max_abs_err={err:.3e} rtol={rtol:g} atol={atol:g}"
          f"{extra} worst_err/tol={use:.3f} rms_want={rms:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: error {use:.3f}x its tolerance "
                             f"(max abs error {err})")
    return err


def _time_ms(fn, flush):
    """Median device time of one call, L2 flushed before each call (the
    flush also keeps the card busy while the host enqueues the call)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(TRIALS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _randn(shape, gen, dtype, scale=1.0):
    import torch
    t = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (t * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 3 + 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_rmsnorm(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm_cuda
    errs = []
    for rows, d, dt in ((512, 4096, torch.bfloat16), (4, 4096, torch.bfloat16),
                        (512, 4096, torch.float32), (7, 104, torch.bfloat16),
                        (3, 100, torch.float32)):
        x = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        errs.append(_compare(f"rmsnorm rows={rows} d={d} {dt}",
                             rmsnorm_cuda.rmsnorm_fwd(x, scale),
                             ref.rmsnorm_ref(x, scale)))
    # the rstd output of the training forward: train shape, f32, ragged
    for rows, d, dt in ((4096, 4096, torch.bfloat16),
                        (4096, 4096, torch.float32),
                        (4099, 4096, torch.bfloat16), (7, 104, torch.float32)):
        x = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        y, rstd = rmsnorm_cuda.rmsnorm_fwd(x, scale, save_residuals=True)
        want_y, want_rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
        errs.append(_compare(f"rmsnorm+rstd rows={rows} d={d} {dt} y", y,
                             want_y))
        errs.append(_compare(f"rmsnorm+rstd rows={rows} d={d} {dt} rstd",
                             rstd, want_rstd))
    # rows that are not whole 16-byte chunks on 16-byte boundaries are
    # refused, never launched
    base = _randn((3 * 104 + 1,), gen, torch.bfloat16)
    for label, x in (("d=100 bf16", _randn((3, 100), gen, torch.bfloat16)),
                     ("misaligned bf16", base[1:].view(3, 104))):
        before = rmsnorm_cuda.launches
        try:
            rmsnorm_cuda.rmsnorm_fwd(x, torch.ones(x.shape[1], device="cuda"))
        except ValueError as e:
            print(f"check rmsnorm refuses {label}: {e}")
        else:
            raise AssertionError(f"rmsnorm accepted {label}")
        if rmsnorm_cuda.launches != before:
            raise AssertionError(f"rmsnorm counted a launch for {label}")
    # the training forward with rstd, timed at the train shape: 4 x 1024
    # tokens of d_model 4096
    rows, d = 4096, 4096
    x = _randn((rows, d), gen, torch.bfloat16)
    scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
    w16 = scale.to(torch.bfloat16)
    train = {
        "ms": _time_ms(lambda: rmsnorm_cuda.rmsnorm_fwd(
            x, scale, save_residuals=True), flush),
        "plain_ms": _time_ms(lambda: ref.rmsnorm_ref(
            x, scale, save_residuals=True), flush),
        "bound_ms": (rows * d * 2 * 2 + d * 4 + rows * 4)
        / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.rms_norm(x, (d,), w16, 1e-6),
                               flush),
        "shape": f"x ({rows}, {d}) bf16, with rstd"}
    # timed at the prefill shape of Yi-6B: 4 slots x 128-token chunk
    rows, d = 512, 4096
    x = _randn((rows, d), gen, torch.bfloat16)
    scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
    w16 = scale.to(torch.bfloat16)
    nbytes = rows * d * 2 * 2 + d * 4
    return {
        "name": "rmsnorm_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:43",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: rmsnorm_cuda.rmsnorm_fwd(x, scale), flush),
        "plain_ms": _time_ms(lambda: ref.rmsnorm_ref(x, scale), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.rms_norm(x, (d,), w16, 1e-6), flush),
        "shape": f"x ({rows}, {d}) bf16",
        "train_shape": train,
    }


def check_decode(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention_cuda, ref
    from repro_torch.models.attention import _cache_positions
    errs = []
    cases = [
        # Yi-6B: B=4 slots, 32 q heads over 4 kv heads, D=128, cache 1024
        (4, 32, 4, 128, 1024, torch.bfloat16, torch.bfloat16),
        (4, 32, 4, 128, 1024, torch.bfloat16, torch.float32),
        (4, 32, 4, 128, 1024, torch.float32, torch.float32),
        (2, 8, 8, 64, 300, torch.float32, torch.float32),     # ragged tile
        (3, 16, 1, 64, 77, torch.bfloat16, torch.bfloat16),  # G=16
    ]
    for b, hq, hkv, d, length, qdt, kvdt in cases:
        q = _randn((b, hq, d), gen, qdt)
        k = _randn((b, length, hkv, d), gen, kvdt)
        v = _randn((b, length, hkv, d), gen, kvdt)
        # ragged per-slot depths: pos 0, mid, last slot, and a fully masked
        # row (an idle slot whose kpos is all -1)
        pos = torch.tensor([0, length // 3, length - 1, length // 2][:b],
                           device="cuda", dtype=torch.int32)
        kpos = _cache_positions(length, pos, None).to(torch.int32)
        if b >= 2:
            kpos[1] = -1
        kpos = kpos.contiguous()
        errs.append(_compare(
            f"decode B={b} Hq={hq} Hkv={hkv} D={d} L={length} q={qdt} "
            f"kv={kvdt}",
            decode_attention_cuda.decode_attention_fwd(q, k, v, kpos, pos),
            ref.decode_attention_ref(q, k, v, kpos, pos)))
    # ring cache (sliding window): rotated slot order
    b, hq, hkv, d, length = 4, 32, 4, 128, 256
    q = _randn((b, hq, d), gen, torch.bfloat16)
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor([5, 300, 511, 1000], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, 256).to(torch.int32).contiguous()
    errs.append(_compare(
        "decode ring window=256",
        decode_attention_cuda.decode_attention_fwd(q, k, v, kpos, pos),
        ref.decode_attention_ref(q, k, v, kpos, pos)))

    # timed at the serving shape: bf16 cache, ragged depths
    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    q = _randn((b, hq, d), gen, torch.bfloat16)
    k = _randn((b, length, hkv, d), gen, torch.bfloat16)
    v = _randn((b, length, hkv, d), gen, torch.bfloat16)
    pos = torch.tensor([100, 400, 700, 1000], device="cuda",
                       dtype=torch.int32)
    kpos = _cache_positions(length, pos, None).to(torch.int32).contiguous()
    valid = (kpos >= 0) & (kpos <= pos[:, None])
    qt = q[:, :, None]                                   # (B, Hq, 1, D)
    kt = k.transpose(1, 2).contiguous()                  # (B, Hkv, L, D)
    vt = v.transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    # least bytes: K and V of the valid cache rows only (a slot reads
    # nothing from rows its kpos marks invalid), q in, out, kpos and pos
    valid_rows = int(valid.sum())
    nbytes = (2 * valid_rows * hkv * d * 2 + 2 * q.numel() * 2
              + kpos.numel() * 4 + b * 4)
    return {
        "name": "decode_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:171",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            q, k, v, kpos, pos), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_ref(
            q, k, v, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
        "shape": f"q ({b}, {hq}, {d}) bf16, cache ({b}, {length}, {hkv}, "
                 f"{d}) bf16, pos {pos.tolist()}, valid rows {valid_rows}",
    }


def _append_inputs(gen, b, c, hq, hkv, d, pos0, dt, *, ring=None):
    """q/k/v/kpos as attend_prefill builds them: a linear prefix
    [0, pos0) + the chunk, or (ring=L) a rotated ring of L rows + chunk."""
    import torch

    from repro_torch.models.attention import _cache_positions
    pre = ring if ring is not None else pos0
    sk = pre + c
    q = _randn((b, c, hq, d), gen, dt)
    k = _randn((b, sk, hkv, d), gen, dt)
    v = _randn((b, sk, hkv, d), gen, dt)
    chunk_pos = pos0 + torch.arange(c, device="cuda")
    if ring is None:
        kpos = torch.arange(sk, device="cuda")
    else:
        kpos_pre = _cache_positions(
            ring, torch.tensor(pos0 - 1, device="cuda"), ring)
        kpos = torch.cat([kpos_pre, chunk_pos])
    kpos = kpos.to(torch.int32).expand(b, sk).contiguous()
    return q, k, v, kpos


def check_append(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_append_cuda, ref
    bf, f32 = torch.bfloat16, torch.float32
    errs = []
    # (label, b, c, hq, hkv, d, pos0, dtype, window, ring, linear, mask_row)
    cases = [
        ("Yi pos0=0", 4, 128, 32, 4, 128, 0, bf, None, None, True, False),
        ("Yi pos0=512", 4, 128, 32, 4, 128, 512, bf, None, None, True, False),
        ("Yi pos0=512 f32", 4, 128, 32, 4, 128, 512, f32, None, None, True,
         False),
        ("window=200 linear skip", 2, 128, 32, 4, 128, 512, bf, 200, None,
         True, False),
        ("ring L=256 window=256", 2, 128, 32, 4, 128, 384, bf, 256, 256,
         False, False),
        ("fully masked row", 2, 128, 8, 4, 128, 128, f32, None, None, False,
         True),
        ("ragged C=100 pos0=37 D=64", 3, 100, 8, 2, 64, 37, f32, None, None,
         True, False),
    ]
    for label, b, c, hq, hkv, d, pos0, dt, window, ring, linear, mrow in cases:
        q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, dt,
                                       ring=ring)
        if mrow:
            kpos[1] = -1
        errs.append(_compare(
            f"append {label} B={b} C={c} Sk={k.shape[1]} Hq={hq} Hkv={hkv} "
            f"D={d} {dt}",
            flash_append_cuda.flash_attention_append(
                q, k, v, kpos, pos0=pos0, window=window, kpos_linear=linear),
            ref.flash_attention_append_ref(q, k, v, kpos, pos0=pos0,
                                           window=window)))

    # timed at the serving shape: the second prompt chunk at pos0 = 512
    b, c, hq, hkv, d, pos0 = 4, 128, 32, 4, 128, 512
    q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, bf)
    sk = k.shape[1]
    qpos = pos0 + torch.arange(c, device="cuda")
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    live_pairs = int(valid.sum())                    # over the batch
    nbytes = (2 * q.numel() + 2 * k.numel()) * 2 + kpos.numel() * 4
    flops = 4 * hq * d * live_pairs
    qt = q.transpose(1, 2).contiguous()              # (B, Hq, C, D)
    kt = k.transpose(1, 2).contiguous()              # (B, Hkv, Sk, D)
    vt = v.transpose(1, 2).contiguous()
    mask = valid[:, None]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    return {
        "name": "flash_attention_append", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_append.cu",
        "replaces": "src/repro/kernels/flash_attention.py:264",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: flash_append_cuda.flash_attention_append(
            q, k, v, kpos, pos0=pos0, kpos_linear=True), flush),
        "plain_ms": _time_ms(lambda: ref.flash_attention_append_ref(
            q, k, v, kpos, pos0=pos0), flush),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
        "shape": f"q ({b}, {c}, {hq}, {d}) bf16, k/v ({b}, {sk}, {hkv}, "
                 f"{d}) bf16, pos0={pos0}, live pairs {live_pairs}",
    }


# int8 arms and kernel 7: no single PyTorch call attends over an int8 cache
# with per-row scales, and none returns the unnormalised (acc, m, l)
NO_INT8_LIBRARY = ("none: no PyTorch call attends over int8 K/V with "
                   "per-(row, kv head) scales")
NO_PARTIALS_LIBRARY = ("none: no PyTorch call returns the unnormalised "
                       "flash-decoding state (acc, m, l)")


def _decode_cache(gen, b, hq, hkv, d, length, qdt, kvdt, pos, *, ring=None,
                  masked_row=None):
    """q, caches and per-slot kpos/pos as attend_decode builds them; kvdt
    int8 gives quantised caches with their scales (else scales None)."""
    import torch

    from repro_torch.kernels import kv_quant
    from repro_torch.models.attention import _cache_positions
    q = _randn((b, hq, d), gen, qdt)
    k = _randn((b, length, hkv, d), gen, torch.float32)
    v = _randn((b, length, hkv, d), gen, torch.float32)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
    else:
        k, v, ks, vs = k.to(kvdt), v.to(kvdt), None, None
    pos = torch.tensor(pos[:b], device="cuda", dtype=torch.int32)
    kpos = _cache_positions(length, pos, ring).to(torch.int32)
    if masked_row is not None and b > masked_row:
        kpos[masked_row] = -1
    return q, k, v, ks, vs, kpos.contiguous(), pos


def _decode_bytes(q, k, ks, kpos, valid_rows, out_bytes):
    """Least bytes of one decode call: K and V (and their scales) of the
    valid cache rows only, q in, the outputs, kpos and pos."""
    hkv, d = k.shape[2], k.shape[3]
    nbytes = 2 * valid_rows * hkv * d * k.element_size()
    if ks is not None:
        nbytes += 2 * valid_rows * hkv * 4
    return (nbytes + q.numel() * q.element_size() + out_bytes
            + kpos.numel() * 4 + q.shape[0] * 4)


def check_decode_int8(gen, flush):
    """Kernel 6's int8 arm: caches int8 with (B, L, Hkv, 1) f32 scales."""
    import torch

    from repro_torch.kernels import decode_attention_cuda, ref
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    errs = []
    # (b, hq, hkv, d, length, q dtype, ring window)
    for b, hq, hkv, d, length, qdt, ring in (
            (4, 32, 4, 128, 1024, bf, None), (4, 32, 4, 128, 1024, f32, None),
            (2, 8, 8, 64, 300, f32, None),      # ragged tile
            (3, 16, 1, 64, 77, bf, None),       # G = 16
            (4, 32, 4, 128, 256, bf, 256)):     # ring
        pos = ([5, 300, 511, 1000] if ring else
               [0, length // 3, length - 1, length // 2])
        q, k, v, ks, vs, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, qdt, i8, pos, ring=ring,
            masked_row=None if ring else 1)
        errs.append(_compare(
            f"decode int8 B={b} Hq={hq} Hkv={hkv} D={d} L={length} q={qdt}"
            f"{' ring' if ring else ''}",
            decode_attention_cuda.decode_attention_fwd(q, k, v, kpos, pos,
                                                       ks, vs),
            ref.decode_attention_quant_ref(q, k, v, ks, vs, kpos, pos)))

    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    q, k, v, ks, vs, kpos, pos = _decode_cache(
        gen, b, hq, hkv, d, length, bf, i8, [100, 400, 700, 1000])
    valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
    nbytes = _decode_bytes(q, k, ks, kpos, valid_rows, q.numel() * 2)
    return {
        "name": "decode_attention_fwd_int8", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:171",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: decode_attention_cuda.decode_attention_fwd(
            q, k, v, kpos, pos, ks, vs), flush),
        "plain_ms": _time_ms(lambda: ref.decode_attention_quant_ref(
            q, k, v, ks, vs, kpos, pos), flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "library_note": NO_INT8_LIBRARY,
        "shape": f"q ({b}, {hq}, {d}) bf16, cache ({b}, {length}, {hkv}, "
                 f"{d}) int8 + scales, pos {pos.tolist()}, valid rows "
                 f"{valid_rows}",
    }


def check_append_int8(gen, flush):
    """Kernel 4's int8 arm: the key stream int8 with (B, Sk, Hkv, 1) f32
    scales, as attend_prefill passes an int8 cache prefix + chunk."""
    import torch

    from repro_torch.kernels import flash_append_cuda, kv_quant, ref
    bf, f32 = torch.bfloat16, torch.float32
    errs = []
    cases = [
        ("Yi pos0=0", 4, 128, 32, 4, 128, 0, bf, None, None, True, False),
        ("Yi pos0=512", 4, 128, 32, 4, 128, 512, bf, None, None, True, False),
        ("Yi pos0=512 f32", 4, 128, 32, 4, 128, 512, f32, None, None, True,
         False),
        ("window=200 linear skip", 2, 128, 32, 4, 128, 512, bf, 200, None,
         True, False),
        ("ring L=256 window=256", 2, 128, 32, 4, 128, 384, bf, 256, 256,
         False, False),
        ("fully masked row", 2, 128, 8, 4, 128, 128, f32, None, None, False,
         True),
        ("ragged C=100 pos0=37 D=64", 3, 100, 8, 2, 64, 37, f32, None, None,
         True, False),
    ]

    def inputs(b, c, hq, hkv, d, pos0, dt, ring):
        q, k, v, kpos = _append_inputs(gen, b, c, hq, hkv, d, pos0, dt,
                                       ring=ring)
        (k, ks), (v, vs) = kv_quant.quantize(k), kv_quant.quantize(v)
        return q, k, v, ks, vs, kpos

    for label, b, c, hq, hkv, d, pos0, dt, window, ring, linear, mrow in cases:
        q, k, v, ks, vs, kpos = inputs(b, c, hq, hkv, d, pos0, dt, ring)
        if mrow:
            kpos[1] = -1
        errs.append(_compare(
            f"append int8 {label} B={b} C={c} Sk={k.shape[1]} Hq={hq} "
            f"Hkv={hkv} D={d} {dt}",
            flash_append_cuda.flash_attention_append(
                q, k, v, kpos, pos0=pos0, window=window, kpos_linear=linear,
                k_scale=ks, v_scale=vs),
            ref.flash_attention_append_quant_ref(q, k, v, ks, vs, kpos,
                                                 pos0=pos0, window=window)))

    b, c, hq, hkv, d, pos0 = 4, 128, 32, 4, 128, 512
    q, k, v, ks, vs, kpos = inputs(b, c, hq, hkv, d, pos0, bf, None)
    sk = k.shape[1]
    qpos = pos0 + torch.arange(c, device="cuda")
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[None, :, None])
    live_pairs = int(valid.sum())
    # q in and out in bf16, K and V one byte an element, a scale per row
    nbytes = (2 * q.numel() * 2 + 2 * k.numel() + 2 * ks.numel() * 4
              + kpos.numel() * 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * hq * d * live_pairs / BF16_FLOPS * 1e3
    return {
        "name": "flash_attention_append_int8", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_append.cu",
        "replaces": "src/repro/kernels/flash_attention.py:264",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: flash_append_cuda.flash_attention_append(
            q, k, v, kpos, pos0=pos0, kpos_linear=True, k_scale=ks,
            v_scale=vs), flush),
        "plain_ms": _time_ms(lambda: ref.flash_attention_append_quant_ref(
            q, k, v, ks, vs, kpos, pos0=pos0), flush),
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": None, "library_note": NO_INT8_LIBRARY,
        "shape": f"q ({b}, {c}, {hq}, {d}) bf16, k/v ({b}, {sk}, {hkv}, "
                 f"{d}) int8 + scales, pos0={pos0}, live pairs {live_pairs}",
    }


def check_partials(gen, flush):
    """Kernel 7 over 1, 2 and 4 slices of the cache, each slice against the
    plain partials (acc, m, l in f32), the slices combined with
    ref.combine_partials against kernel 6 on the whole cache and against
    the plain decode; bf16 and int8 caches.  Rows: pos 100 (slices past it
    fully masked), an all-masked row, the last slot, 700; and a ragged
    shape (L = 300, slices of 150 and 75 rows, ragged key tiles).  The
    acc check carries the long-sum slack (SUM_ABS_TOL), loose enough to
    pass a sum kept in lower precision; the combined outputs do not: an
    f32 q over an f32 cache at L = 1024 holds the combine of 1, 2 and 4
    slices to 1e-5, which such a sum would miss.  Returns the records of
    the float arm (bf16 and f32 caches) and the int8 arm."""
    import torch

    from repro_torch.kernels import decode_attention_cuda, ref
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    errs = {bf: [], f32: [], i8: []}
    for kvdt in (bf, f32, i8):
        for b, hq, hkv, d, length, qdt, rows in (
                (4, 32, 4, 128, 1024, f32 if kvdt == f32 else bf,
                 [100, 400, 1023, 700]),
                (2, 8, 2, 64, 300, f32, [100, 250])):
            q, k, v, ks, vs, kpos, pos = _decode_cache(
                gen, b, hq, hkv, d, length, qdt, kvdt, rows, masked_row=1)
            whole = decode_attention_cuda.decode_attention_fwd(
                q, k, v, kpos, pos, ks, vs)
            plain = (ref.decode_attention_quant_ref(q, k, v, ks, vs, kpos,
                                                    pos) if ks is not None
                     else ref.decode_attention_ref(q, k, v, kpos, pos))
            for n in (1, 2, 4):
                step = length // n
                parts = []
                for i in range(n):
                    s = slice(i * step, (i + 1) * step)
                    sl = [None if t is None else t[:, s].contiguous()
                          for t in (k, v, ks, vs, kpos)]
                    got = decode_attention_cuda.decode_attention_partials(
                        q, sl[0], sl[1], sl[4], pos, sl[2], sl[3])
                    want = ref.decode_attention_partials_ref(
                        q, sl[0], sl[1], sl[4], pos, sl[2], sl[3])
                    # acc is a sum over up to L keys (all of them, at
                    # weight 1, in a fully masked slice): its terms' sum
                    # over |v| scales its f32 summation-order error
                    acc_abs = ref.decode_attention_partials_ref(
                        q, sl[0], sl[1].abs(), sl[4], pos, sl[2], sl[3])[0]
                    for name, g_, w_, a_ in zip(("acc", "m", "l"), got, want,
                                                (acc_abs, None, None)):
                        errs[kvdt].append(_compare(
                            f"partials {kvdt} B={b} L={length} slice {i}/{n} "
                            f"{name}", g_, w_, sum_abs=a_))
                    parts.append(got)
                o = ref.combine_partials(parts).to(q.dtype)
                label = f"partials {kvdt} B={b} L={length} {n} slices combined"
                errs[kvdt].append(_compare(label + " vs decode kernel", o,
                                           whole))
                errs[kvdt].append(_compare(label + " vs plain", o, plain))

    records = []
    b, hq, hkv, d, length = 4, 32, 4, 128, 1024
    for kvdt, suffix in ((bf, ""), (i8, "_int8")):
        q, k, v, ks, vs, kpos, pos = _decode_cache(
            gen, b, hq, hkv, d, length, bf, kvdt, [100, 400, 700, 1000])
        valid_rows = int(((kpos >= 0) & (kpos <= pos[:, None])).sum())
        # outputs: acc (B, Hkv, G, D), m and l (B, Hkv, G), f32
        nbytes = _decode_bytes(q, k, ks, kpos, valid_rows,
                               b * hq * (d + 2) * 4)
        records.append({
            "name": "decode_attention_partials" + suffix, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:188",
            "max_abs_err": max(errs[kvdt] + (errs[f32] if kvdt == bf
                                             else [])),
            "ms": _time_ms(lambda: decode_attention_cuda
                           .decode_attention_partials(q, k, v, kpos, pos, ks,
                                                      vs), flush),
            "plain_ms": _time_ms(lambda: ref.decode_attention_partials_ref(
                q, k, v, kpos, pos, ks, vs), flush),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library_note": NO_PARTIALS_LIBRARY + (
                "; " + NO_INT8_LIBRARY if ks is not None else ""),
            "shape": f"q ({b}, {hq}, {d}) bf16, one slice: cache ({b}, "
                     f"{length}, {hkv}, {d}) "
                     f"{'int8 + scales' if ks is not None else 'bf16'}, "
                     f"pos {pos.tolist()}, valid rows {valid_rows}",
        })
    return records


def check_rmsnorm_bwd(gen, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm_cuda
    errs = []
    for rows, d, dt in ((4096, 4096, torch.bfloat16),
                        (4096, 4096, torch.float32),
                        (4099, 4096, torch.bfloat16), (7, 104, torch.float32),
                        (1, 256, torch.bfloat16)):
        x = _randn((rows, d), gen, dt)
        dy = _randn((rows, d), gen, dt)
        scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
        _, rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
        dx, dscale = rmsnorm_cuda.rmsnorm_bwd(x, scale, rstd, dy)
        want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, rstd, dy)
        label = f"rmsnorm_bwd rows={rows} d={d} {dt}"
        errs.append(_compare(label + " dx", dx, want_dx))
        terms = (dy.float() * x.float() * rstd[:, None]).abs().sum(0)
        errs.append(_compare(label + " dscale", dscale, want_ds,
                             sum_abs=terms))

    # timed at the train shape
    rows, d = 4096, 4096
    x = _randn((rows, d), gen, torch.bfloat16)
    dy = _randn((rows, d), gen, torch.bfloat16)
    scale = _randn((d,), gen, torch.float32, 0.5) + 1.0
    _, rstd = ref.rmsnorm_ref(x, scale, save_residuals=True)
    xl = x.clone().requires_grad_(True)
    wl = scale.to(torch.bfloat16).requires_grad_(True)
    yl = F.rms_norm(xl, (d,), wl, 1e-6)
    # least bytes: x, dy and rstd in, dx and dscale out
    nbytes = 3 * rows * d * 2 + rows * 4 + 2 * d * 4
    return {
        "name": "rmsnorm_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm_bwd.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:92",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: rmsnorm_cuda.rmsnorm_bwd(x, scale, rstd, dy),
                       flush),
        "plain_ms": _time_ms(lambda: ref.rmsnorm_bwd_ref(x, scale, rstd, dy),
                             flush),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": _time_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True), flush),
        "shape": f"x, dy ({rows}, {d}) bf16",
    }


# (label, B, S, Hq, Hkv, D, dtype, causal, window)
_TRAIN_SHAPE = ("train shape", 4, 1024, 32, 4, 128, "bf16", True, None)
_F32_TRAIN_SHAPE = ("train shape f32", 4, 1024, 32, 4, 128, "f32", True,
                    None)
_FLASH_CASES = [
    _TRAIN_SHAPE,
    ("f32", 2, 1024, 32, 4, 128, "f32", True, None),
    ("window=256", 2, 1024, 32, 4, 128, "bf16", True, 256),
    ("causal=False", 2, 512, 32, 4, 128, "bf16", False, None),
    ("ragged S=1000 D=64", 2, 1000, 8, 2, 64, "f32", True, None),
    ("G=1", 2, 512, 8, 8, 128, "bf16", True, None),
    # the bf16 arm's ragged edge and D = 64
    ("ragged S=1000 D=64 bf16", 2, 1000, 8, 2, 64, "bf16", True, None),
    # at most 16 keys a query: one key dropped or added moves an output by
    # far more than ROUND_TOL of its sum over |terms|
    ("window=16", 2, 1024, 32, 4, 128, "bf16", True, 16),
]


def _flash_inputs(gen, case):
    import torch
    _, b, s, hq, hkv, d, dt, causal, window = case
    dt = torch.bfloat16 if dt == "bf16" else torch.float32
    q = _randn((b, s, hq, d), gen, dt)
    k = _randn((b, s, hkv, d), gen, dt)
    v = _randn((b, s, hkv, d), gen, dt)
    do = _randn((b, s, hq, d), gen, dt)
    return q, k, v, do, causal, window


def _live_pairs(b, s, hq, causal, window):
    """(query, key) pairs the mask keeps, over batch and q heads."""
    import torch
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return int(keep.sum()) * b * hq


def _flash_bound(q, k, live, ops_per_pair, n_q_like, n_kv_like):
    """(bound_ms, bound_by) of a flash kernel: its operations over the peak
    for its dtype (bf16 tensor cores; f32 outside them) against the bytes
    of n_q_like (B, S, Hq, D) and n_kv_like (B, S, Hkv, D) tensors plus lse
    moved once."""
    import torch
    b, s, hq, d = q.shape
    width = q.element_size()
    nbytes = (n_q_like * q.numel() + n_kv_like * k.numel()) * width + \
        b * hq * s * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    by_ops = ops_per_pair * d * live / peak * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def check_flash_fwd(gen, flush):
    """Both arms of the forward against the plain version; records for the
    bf16 (tensor-core) arm and the f32 (SIMT) arm, each timed at the train
    shape in its dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_cuda, ref
    errs = {torch.bfloat16: [], torch.float32: []}
    for case in _FLASH_CASES:
        q, k, v, _, causal, window = _flash_inputs(gen, case)
        o, lse = flash_attention_cuda.flash_attention_fwd(
            q, k, v, causal=causal, window=window)
        want_o, want_lse = ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)
        # the bf16 arm rounds p to bf16 before p @ V, as the TPU kernel
        round_abs = None
        if q.dtype == torch.bfloat16:
            round_abs = ref.flash_round_scale(q, k, v, want_o, want_lse,
                                              None, causal, window)[0]
        label = f"flash_fwd {case[0]} {tuple(q.shape)}/{k.shape[2]} {q.dtype}"
        errs[q.dtype].append(_compare(label + " o", o, want_o,
                                      round_abs=round_abs))
        errs[q.dtype].append(_compare(label + " lse", lse, want_lse))
        del round_abs

    records = []
    for case, name in ((_TRAIN_SHAPE, "flash_attention_fwd"),
                       (_F32_TRAIN_SHAPE, "flash_attention_fwd_f32")):
        q, k, v, _, causal, window = _flash_inputs(gen, case)
        b, s, hq, d = q.shape
        live = _live_pairs(b, s, hq, causal, window)
        bound, bound_by = _flash_bound(q, k, live, 4, 2, 2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        arm = "tensor cores" if q.dtype == torch.bfloat16 else "SIMT"
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:129",
            "max_abs_err": max(errs[q.dtype]),
            "ms": _time_ms(lambda: flash_attention_cuda.flash_attention_fwd(
                q, k, v), flush),
            "plain_ms": _time_ms(lambda: ref.flash_attention_ref(q, k, v),
                                 flush),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush),
            "shape": f"q ({b}, {s}, {hq}, {d}) {q.dtype}, k/v {k.shape[2]} "
                     f"heads, causal, live pairs {live}, {arm}",
        })
        del q, k, v, qt, kt, vt
    return records


def _bwd_sum_abs(q, k, v, o, lse, do, causal, window):
    """dq, dk, dv recomputed over absolute values (|ds| from |dp| and
    |delta| taken as sums of |terms|): the scale of each output's f32
    summation-order error (SUM_ABS_TOL)."""
    import torch

    from repro_torch.kernels import ref
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    p = torch.exp(ref._train_logits(q, k, causal, window)
                  - lse.transpose(1, 2).reshape(b, s, hkv, g, 1))
    dog = do.reshape(b, s, hkv, g, d).float().abs()
    delta = (dog * o.reshape(b, s, hkv, g, d).float().abs()).sum(-1, True)
    dp = torch.einsum("bshgd,bthd->bshgt", dog, v.float().abs())
    ds = p * (dp + delta) * d ** -0.5
    qg = q.reshape(b, s, hkv, g, d).float().abs()
    return (torch.einsum("bshgt,bthd->bshgd", ds,
                         k.float().abs()).reshape(b, s, hq, d),
            torch.einsum("bshgt,bshgd->bthd", ds, qg),
            torch.einsum("bshgt,bshgd->bthd", p, dog))


def check_flash_bwd(gen, flush):
    """Both arms of the backward against the plain version; records for the
    bf16 and the f32 arm, each timed at the train shape in its dtype."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd_cuda, ref
    errs = {torch.bfloat16: [], torch.float32: []}
    for case in _FLASH_CASES:
        q, k, v, do, causal, window = _flash_inputs(gen, case)
        o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        got = flash_attention_bwd_cuda.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, window=window)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window)
        scale = _bwd_sum_abs(q, k, v, o, lse, do, causal, window)
        # the bf16 arm rounds ds (dq, dk) and p (dv) to bf16, as the TPU
        # kernel
        rounding = (None, None, None)
        if q.dtype == torch.bfloat16:
            rounding = ref.flash_round_scale(q, k, v, o, lse, do, causal,
                                             window)[1:]
        label = f"flash_bwd {case[0]} {tuple(q.shape)}/{k.shape[2]} {q.dtype}"
        for name, g_, w_, m_, r_ in zip(("dq", "dk", "dv"), got, want, scale,
                                        rounding):
            errs[q.dtype].append(_compare(f"{label} {name}", g_, w_,
                                          sum_abs=m_, round_abs=r_))
        del scale, got, want, rounding

    records = []
    for case, name in ((_TRAIN_SHAPE, "flash_attention_bwd"),
                       (_F32_TRAIN_SHAPE, "flash_attention_bwd_f32")):
        q, k, v, do, causal, window = _flash_inputs(gen, case)
        o, lse = ref.flash_attention_ref(q, k, v)
        b, s, hq, d = q.shape
        live = _live_pairs(b, s, hq, causal, window)
        # s, dp, dq, dk, dv: five products of D; least bytes: q, o, do, k,
        # v and lse in, dq, dk, dv out
        bound, bound_by = _flash_bound(q, k, live, 10, 4, 4)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        arm = "tensor cores" if q.dtype == torch.bfloat16 else "SIMT"
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention_bwd.py:142",
            "max_abs_err": max(errs[q.dtype]),
            "ms": _time_ms(lambda: flash_attention_bwd_cuda
                           .flash_attention_bwd(q, k, v, o, lse, do), flush),
            "plain_ms": _time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do), flush),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": _time_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True), flush),
            "shape": f"q, o, do ({b}, {s}, {hq}, {d}) {q.dtype}, k/v "
                     f"{k.shape[2]} heads, causal, live pairs {live}, {arm}",
        })
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
    return records


def check_rmsprop(gen, flush):
    import torch

    from repro_torch.kernels import ref, rmsprop_cuda
    errs = []
    # one MLP matrix of Yi-6B (4096 x 11008), one element, a ragged count
    for n in (4096 * 11008, 1, 4099):
        g = _randn((n,), gen, torch.float32).abs()
        grad = _randn((n,), gen, torch.float32, 3.0)
        want_g, want_u = ref.rmsprop_update_ref(g, grad, lr=7e-3)
        got_g, got_u = rmsprop_cuda.rmsprop_update(g.clone(), grad, lr=7e-3)
        errs.append(_compare(f"rmsprop n={n} g'", got_g, want_g))
        errs.append(_compare(f"rmsprop n={n} update", got_u, want_u))

    n = 4096 * 11008
    g = _randn((n,), gen, torch.float32).abs()
    grad = _randn((n,), gen, torch.float32, 3.0)
    return {
        "name": "rmsprop_update", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsprop.cu",
        "replaces": "src/repro/kernels/shared_rmsprop.py:34",
        "max_abs_err": max(errs),
        "ms": _time_ms(lambda: rmsprop_cuda.rmsprop_update(g, grad, lr=7e-3),
                       flush),
        "plain_ms": _time_ms(lambda: ref.rmsprop_update_ref(g, grad,
                                                            lr=7e-3), flush),
        "bound_ms": 16 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        # torch.optim.RMSprop puts eps outside the square root and returns
        # no update: no single PyTorch call computes paper Eq. 8-9
        "library_ms": None,
        "shape": f"one f32 leaf of {n} elements (4096 x 11008)",
    }


# ---------------------------------------------------------------------------
# phase 5: the model and the engine
# ---------------------------------------------------------------------------

def check_model_small():
    """Reduced Yi-6B in f32: prefill + per-slot decode logits on the card
    (kernels) against the CPU (plain versions)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    outs = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(cfg, 0, "cpu")
        params = M.tree_map(lambda t: t.to(dev), params)
        cache = M.init_cache(cfg, 2, 64, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)),
                               device=dev)
        seq = []
        for p0 in (0, 32):
            out, cache = M.prefill_step(cfg, params, cache,
                                        {"tokens": toks[:, p0:p0 + 32]}, p0)
            seq.append(out["logits"])
        pos = torch.tensor([40, 37], device=dev)
        for _ in range(3):
            nxt = seq[-1][:, -1:].argmax(-1)
            out, cache = M.decode_step(cfg, params, cache, {"tokens": nxt},
                                       pos)
            seq.append(out["logits"])
            pos = pos + 1
        outs[dev] = [t.float().cpu() for t in seq]
    err = 0.0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if not torch.isfinite(a).all():
            raise AssertionError("model: non-finite logits on the card")
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"model: card vs CPU logits differ by {err}")
    print(f"check model reduced yi-6b f32 cuda vs cpu: max_abs_err="
          f"{err:.3e} tol=1e-4 ok")


# the attention kernels and arms of the serving path; each serving run
# launches exactly two of them (_serving_arms) and none of the others
SERVING_ARMS = ("flash_append", "flash_append_int8", "decode_attention",
                "decode_attention_int8", "decode_attention_partials",
                "decode_attention_partials_int8")


def _serving_arms(kv, cp):
    """The append arm and the decode kernel and arm that a serving run
    with KV dtype ``kv`` launches: the partials kernel under decode_cp,
    kernel 6 otherwise."""
    sfx = "_int8" if kv == "int8" else ""
    decode = "decode_attention_partials" if cp else "decode_attention"
    return "flash_append" + sfx, decode + sfx


def _check_serving_run(label, rep, counts, kv, cp):
    """The run took the layout and the kernels its flags ask for: the
    report's decode_layout and kv dtype, the rmsnorm and its two arms
    launched, every other serving arm not launched."""
    layout = "decode_cp[1]" if cp else "replicated"
    if rep["decode_layout"] != layout or rep["kv_dtype"] != kv:
        raise AssertionError(f"{label}: layout {rep['decode_layout']} kv "
                             f"{rep['kv_dtype']}, expected {layout} {kv}")
    want = ("rmsnorm",) + _serving_arms(kv, cp)
    missing = [k for k in want if counts[k] <= 0]
    stray = {k: counts[k] for k in SERVING_ARMS
             if k not in want and counts[k] != 0}
    if missing or stray:
        raise AssertionError(f"{label}: kernels never launched {missing}, "
                             f"launched off its path {stray}")


def build_yi6b():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    print(f"yi-6b params {cfg.param_count()} built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def run_yi6b_engine(cfg, params, kv, cp):
    """Phase 5's trace (8 greedy requests) through ``run_engine`` on Yi-6B
    at full width and depth with KV dtype ``kv``, under decode_cp[1] over
    the one-rank NCCL group installed by the caller when ``cp``.  Returns
    the launch counts of that run alone."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    trace = serve.gen_trace(8, vocab=cfg.vocab_size, prompt_range=(64, 600),
                            gen_range=(16, 48), arrival_rate=0.0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    rep = serve.run_engine(cfg, params, trace, n_slots=4, cache_len=1024,
                           chunk=128, sample=False, seed=0, kv_dtype=kv,
                           device="cuda", decode_cp=cp)
    counts = dispatch.launch_counts()
    label = f"engine yi-6b full width x 32 layers {rep['decode_layout']} {kv}"
    unfinished = [r.rid for r in trace if len(r.tokens) != r.max_new]
    if rep["requests"] != len(trace) or unfinished:
        raise AssertionError(f"{label}: requests {unfinished} did not finish")
    if not rep["logits_finite"]:
        raise AssertionError(f"{label}: non-finite logits")
    _check_serving_run(label, rep, counts, kv, cp)
    print(f"{label}: " + json.dumps({k: rep[k] for k in (
        "requests", "generated_tokens", "prefill_tokens", "wall_s",
        "tokens_per_s", "decode_tokens_per_s", "prefill_wall_s", "ttft_s",
        "latency_s", "warmup_s", "logits_finite", "decode_layout",
        "cp_combine_bytes_per_token")}))
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    shown = {k: counts[k] for k in ("rmsnorm",) + SERVING_ARMS}
    print(f"{label}: kernel launches {json.dumps(shown)}")
    return counts


def _profile(label, fn, wall_ms=None, watch=()):
    """Device busy share of ``fn`` from a torch.profiler trace: the summed
    time of the kernels it ran (one stream, so they do not overlap) over
    its wall time without the profiler (``wall_ms``, or one more run of
    ``fn``), the kernels that took the most device time, the kernels whose
    names hold one of ``watch`` wherever they rank, and the host ops that
    took the most host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    plain_wall = wall_ms
    if plain_wall is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {label}: wall_ms={plain_wall:.2f} (profiled "
          f"{wall:.2f}) device_busy_ms={busy:.2f} busy_share="
          f"{busy / plain_wall:.3f} (of the profiled wall "
          f"{busy / wall:.3f})")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for rank, e in enumerate(ranked):
        if rank < 8 or any(w in e.key for w in watch):
            print(f"profile {label}: #{rank + 1:<3d}"
                  f"{e.self_device_time_total / 1e3:8.2f} ms x{e.count:<5d} "
                  f"{e.key[:90]}")
    # where the host spends a host-bound window (profiled: inflated by the
    # profiler's own cost, so read the shares, not the times)
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    total = sum(e.self_cpu_time_total for e in host) / 1e3
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"profile {label}:   host {e.self_cpu_time_total / 1e3:8.2f} "
              f"ms of {total:.2f} x{e.count:<6d} {e.key[:60]}")


def profile_engine(cfg, params, label, **engine_kw):
    """Where a full-width engine step spends its time: one admission of
    four prompts (chunked prefill) and eight decode steps of four slots,
    on an engine built with ``engine_kw`` (kv dtype, decode_cp)."""
    from repro_torch.launch import serve
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            chunk=128, sample=False, device="cuda",
                            **engine_kw)
    reqs = iter(serve.gen_trace(8, vocab=cfg.vocab_size,
                                prompt_range=(64, 600), gen_range=(64, 64),
                                arrival_rate=0.0, seed=1))
    # each call admits four fresh requests into the four slots
    _profile(f"{label} admission of 4 prompts", lambda: eng.admit(
        [(next(reqs), j) for j in range(4)], 0.0))
    for _ in range(2):
        eng.decode_step_all()

    def decode():
        for _ in range(8):
            eng.decode_step_all()
    _profile(f"{label} 8 decode steps x 4 slots", decode)


def check_cp_reduced():
    """Phase 6c: reduced Yi-6B on the card, greedy, 6 requests: the engine
    under decode_cp[1] emits the tokens of the engine without it, with an
    int8 and with a bf16 cache (one rank: the partials kernel and the
    combine compute kernel 6's arithmetic).  Each of the four runs is its
    own path, with the counters set to 0 just before it and read just
    after; returns {path: counts}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b").reduced()
    params = M.init_params(cfg, 0, "cuda")
    counts = {}
    for kv in ("int8", "bf16"):
        tokens = {}
        for cp in (False, True):
            path = f"reduced_{kv}" + ("_cp" if cp else "")
            trace = serve.gen_trace(6, vocab=cfg.vocab_size,
                                    prompt_range=(3, 20), gen_range=(1, 8),
                                    arrival_rate=0.0, seed=5)
            dispatch.reset_launch_counts()
            rep = serve.run_engine(cfg, params, trace, n_slots=2,
                                   cache_len=32, chunk=8, sample=False,
                                   seed=0, kv_dtype=kv, device="cuda",
                                   decode_cp=cp)
            counts[path] = dispatch.launch_counts()
            if not rep["logits_finite"]:
                raise AssertionError(f"{path}: non-finite logits")
            _check_serving_run(path, rep, counts[path], kv, cp)
            tokens[cp] = {r.rid: list(r.tokens) for r in trace}
        if tokens[True] != tokens[False]:
            raise AssertionError(f"reduced yi-6b {kv}: decode_cp[1] tokens "
                                 f"{tokens[True]} != {tokens[False]}")
        print(f"check reduced yi-6b {kv} KV decode_cp[1] vs replicated: "
              f"{sum(len(t) for t in tokens[True].values())} greedy tokens "
              "identical, each run through its own kernels ok")
    return counts


# ---------------------------------------------------------------------------
# phases 7 and 8: the learner
# ---------------------------------------------------------------------------

def check_train_small():
    """Reduced Yi-6B in f32: three train steps on the card (kernels)
    against the same steps on the CPU (plain versions), from the same
    parameters and batches.  The card's steps are a path of their own:
    they launch the flash kernels' f32 arms and not their bf16 arms.
    Returns their launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import llm_a3c
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfg = get_config("yi-6b").reduced()
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=128, global_batch=2,
                         device="cpu")
    batches = [pipe.batch(0, i) for i in range(3)]
    runs = {}
    for dev in ("cpu", "cuda"):
        params = M.tree_map(lambda t: t.to(dev),
                            M.init_params(cfg, 0, "cpu"))
        opt = opt_mod.shared_rmsprop()
        state = opt.init(params)
        step = llm_a3c.make_train_step(cfg, opt)     # lr0 7e-4
        losses = []
        dispatch.reset_launch_counts()
        for i, b in enumerate(batches):
            b = {k: v.to(dev) for k, v in b.items()}
            params, state, met = step(params, state, b, i)
            losses.append(float(met["loss"]))
        counts = dispatch.launch_counts()
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                              M.flatten(params).items()})
    (loss_c, par_c), (loss_g, par_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    par_err = 0.0
    for k, want in par_c.items():
        got = par_g[k]
        par_err = max(par_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"train: {k} differs on the card by "
                                 f"{float((got - want).abs().max())}")
    if loss_err > 1e-4:
        raise AssertionError(f"train: losses {loss_g} on the card vs "
                             f"{loss_c} on the CPU")
    _check_flash_arms("train reduced yi-6b f32", counts, "f32")
    print(f"check train reduced yi-6b f32 3 steps cuda vs cpu: losses "
          f"{[round(x, 4) for x in loss_g]} rel_err={loss_err:.2e} (tol "
          f"1e-4) params max_abs_err={par_err:.2e} (rtol=atol=1e-5) ok")
    return counts


FLASH_ARMS = {"bf16": ("flash_attention", "flash_attention_bwd"),
              "f32": ("flash_attention_f32", "flash_attention_bwd_f32")}


def _check_flash_arms(label, counts, arm, per_step=None):
    """A train path launched the flash kernels' ``arm`` (forward and
    backward; exactly ``per_step`` = (forward, backward) launches when
    given) and never the other arm."""
    other = "f32" if arm == "bf16" else "bf16"
    fwd, bwd = FLASH_ARMS[arm]
    got = (counts[fwd], counts[bwd])
    stray = {k: counts[k] for k in FLASH_ARMS[other] if counts[k] != 0}
    if min(got) <= 0 or stray or (per_step is not None and got != per_step):
        raise AssertionError(f"{label}: flash launches {arm} {got} (want "
                             f"{per_step or 'some of each'}), {other} "
                             f"{stray}")
    print(f"check {label}: flash launches {arm} arms {fwd}={got[0]} "
          f"{bwd}={got[1]}, {other} arms none ok")


TRAIN_COUNTERS = ("rmsnorm", "rmsnorm_bwd", "flash_attention",
                  "flash_attention_bwd", "rmsprop")


def run_yi6b_train():
    """Yi-6B at full width, 16 of 32 layers (f32 masters, f32 gradients
    and the f32 RMSProp accumulator of all 32 would take 14 B x 6.06e9 =
    84.9 GB): one warm-up, three timed and one profiled train step on
    TokenPipeline batches of 4 x 1024 tokens."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import llm_a3c
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=16,
                              dtype="bfloat16", remat=True)
    batch_rows, seq = 4, 1024
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda")
    opt = opt_mod.shared_rmsprop()
    state = opt.init(params)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=seq,
                         global_batch=batch_rows, device="cuda")
    step_fn = llm_a3c.make_train_step(cfg, opt, lr0=7e-3, total_steps=100)
    torch.cuda.synchronize()
    print(f"train yi-6b x16 layers: {cfg.param_count()} f32 parameters and "
          f"their accumulator built on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    @torch.no_grad()
    def fingerprint():
        return [(float(t.double().sum()), float(t.double().square().sum()))
                for t in M.flatten(params).values()]

    losses = []
    step = 0

    def one_step():
        nonlocal params, state, step
        batch = pipe.batch(2, step)
        params, state, met = step_fn(params, state, batch, step)
        losses.append(met)
        step += 1

    torch.cuda.reset_peak_memory_stats()
    one_step()                                  # warm-up
    torch.cuda.synchronize()
    before = fingerprint()
    dispatch.reset_launch_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = dispatch.launch_counts()
    after = fingerprint()
    peak = torch.cuda.max_memory_allocated() / 2**30

    loss_vals = [float(m["loss"]) for m in losses]
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"train: non-finite loss {loss_vals}")
    # a non-finite gradient would leave a non-finite accumulator
    bad = [k for k, g in M.flatten(state["g"]).items()
           if not bool(torch.isfinite(g).all())]
    bad += [k for k, p in M.flatten(params).items()
            if not bool(torch.isfinite(p).all())]
    if bad:
        raise AssertionError(f"train: non-finite gradients in {bad[:5]}")
    same = [k for k, a, b in zip(M.flatten(params), before, after) if a == b]
    if same:
        raise AssertionError(f"train: leaves unchanged by 3 steps: {same}")
    missing = [k for k in TRAIN_COUNTERS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")
    # 3 steps of 16 layers: a forward and its remat, one backward a layer
    _check_flash_arms("train yi-6b x16 layers 3 steps", counts, "bf16",
                      (3 * 2 * cfg.n_layers, 3 * cfg.n_layers))
    per_step = {k: counts[k] / 3 for k in TRAIN_COUNTERS}
    wall = statistics.median(walls)
    print("train yi-6b full width x 16 layers: " + json.dumps({
        "losses": loss_vals, "step_wall_s": walls,
        "step_wall_median_s": wall,
        "tokens_per_s": batch_rows * seq / wall,
        "peak_device_memory_gib": peak,
        "launches_per_step": per_step}))
    _profile("train step", one_step, wall_ms=wall * 1e3,
             watch=("flash_fwd", "dq_mma", "dkv_mma", "dkv_sum"))
    return counts


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); nothing was run")
    from repro_torch.distributed import sharding
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"cc {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    build.library()
    print(f"build_s {time.perf_counter() - t0:.1f} (nvcc "
          f"{build.build_seconds:.1f} s)")
    for r in build.kernel_resources(build.build_log):
        print(f"ptxas {r['name']}: registers={r.get('registers')} "
              f"spill_stores={r.get('spill_stores')} "
              f"spill_loads={r.get('spill_loads')} stack={r.get('stack')}")

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = [check_rmsnorm(gen, flush), check_append(gen, flush),
               check_append_int8(gen, flush), check_decode(gen, flush),
               check_decode_int8(gen, flush), *check_partials(gen, flush),
               check_rmsnorm_bwd(gen, flush), *check_flash_fwd(gen, flush),
               *check_flash_bwd(gen, flush), check_rmsprop(gen, flush)]
    del flush
    for r in records:
        for sub in (r, r.get("train_shape")):
            if sub is not None:
                lib = sub["library_ms"]
                sub["x_bound"] = sub["ms"] / sub["bound_ms"]
                sub["x_library"] = None if lib is None else sub["ms"] / lib
    for r in records:
        for sub in (r, r.get("train_shape")):
            if sub is None:
                continue
            lib = sub["library_ms"]
            lib = sub.get("library_note", "none") if lib is None else \
                f"{lib:.4f}"
            xlib = "none" if sub["x_library"] is None else \
                f"{sub['x_library']:.2f}"
            print(f"kernel {r['name']} [{sub['shape']}]: kernel_ms="
                  f"{sub['ms']:.4f} bound_ms={sub['bound_ms']:.4f} "
                  f"({sub['bound_by']}) plain_ms={sub['plain_ms']:.4f} "
                  f"library_ms={lib} x_bound={sub['x_bound']:.2f} "
                  f"x_library={xlib}")
    print(f"phase kernels_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    check_model_small()
    cfg, params = build_yi6b()
    path_counts = {"engine": run_yi6b_engine(cfg, params, "bf16", False)}
    profile_engine(cfg, params, "bf16", kv_dtype="bf16")
    path_counts["engine_int8"] = run_yi6b_engine(cfg, params, "int8", False)
    print(f"phase engine_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    with sharding.process_group(torch.device("cuda")):
        path_counts["engine_cp_int8"] = run_yi6b_engine(cfg, params, "int8",
                                                        True)
        profile_engine(cfg, params, "decode_cp[1] int8", kv_dtype="int8",
                       decode_cp=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        path_counts.update(check_cp_reduced())
    print(f"phase engine_cp_s {time.perf_counter() - t_phase:.1f}")

    t_phase = time.perf_counter()
    path_counts["train_small_f32"] = check_train_small()
    path_counts["train_3_steps"] = run_yi6b_train()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase train_s {time.perf_counter() - t_phase:.1f}")

    by_op = {"rmsnorm_fwd": "rmsnorm",
             "flash_attention_append": "flash_append",
             "flash_attention_append_int8": "flash_append_int8",
             "decode_attention_fwd": "decode_attention",
             "decode_attention_fwd_int8": "decode_attention_int8",
             "decode_attention_partials": "decode_attention_partials",
             "decode_attention_partials_int8":
                 "decode_attention_partials_int8",
             "rmsnorm_bwd": "rmsnorm_bwd",
             "flash_attention_fwd": "flash_attention",
             "flash_attention_fwd_f32": "flash_attention_f32",
             "flash_attention_bwd": "flash_attention_bwd",
             "flash_attention_bwd_f32": "flash_attention_bwd_f32",
             "rmsprop_update": "rmsprop"}
    for r in records:
        op = by_op[r["name"]]
        paths = {path: c[op] for path, c in path_counts.items()}
        r["launches_by_path"] = {k: n for k, n in paths.items() if n}
        r["launches"] = sum(paths.values())
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} never launched on a main path")
        del r["shape"]
        if "train_shape" in r:
            del r["train_shape"]["shape"]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
