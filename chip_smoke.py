#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  3. hold each kernel to its plain PyTorch version on the card, at the
     serving shapes of Yi-6B and at edge cases (ragged per-slot pos, pos 0,
     a fully masked row, pos0 in {0, 512}, a sliding window, a ring layout,
     ragged tiles, f32 and bf16): f32 within rtol = atol = 1e-5, bf16
     within two bf16 ulps (rtol = 2**-6) and atol = 1e-5; the rmsnorm
     wrapper must refuse rows it cannot move in 16-byte chunks;
  4. time each kernel, its plain version and the nearest single PyTorch
     call with CUDA events (median, L2 flushed before each call) beside the
     least time the card could take for the same work;
  5. the port's model on a small input on the card against the same model
     on the CPU, then ``run_engine`` on Yi-6B at full width and depth (bf16
     weights from a seed, bf16 KV, 4 slots, cache 1024, chunk 128, 8 greedy
     requests): every request completes, all logits are finite and every
     kernel was launched on that run;
  6. a torch.profiler trace of one admission and of eight decode steps of
     that engine: wall time, device busy share and the top kernels.

The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero and prints no result.
"""
import json
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TRIALS = 25


def _tol(dtype):
    import torch
    return F32_TOL if dtype == torch.float32 else BF16_TOL


def _compare(what, got, want):
    """Max abs error of got vs want; raises where any element is beyond
    atol + rtol * |want| for the output's dtype."""
    import torch
    rtol, atol = _tol(want.dtype)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    err = float(diff.max())
    # worst element's share of its own tolerance (<= 1 passes)
    use = float((diff / (atol + rtol * want.abs())).max())
    ok = use <= 1.0
    rms = float(want.square().mean().sqrt())
    print(f"check {what}: max_abs_err={err:.3e} rtol={rtol:g} atol={atol:g} "
          f"worst_err/tol={use:.3f} rms_want={rms:.3e} "
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


def run_yi6b_engine():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    print(f"yi-6b params {cfg.param_count()} built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    trace = serve.gen_trace(8, vocab=cfg.vocab_size, prompt_range=(64, 600),
                            gen_range=(16, 48), arrival_rate=0.0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    rep = serve.run_engine(cfg, params, trace, n_slots=4, cache_len=1024,
                           chunk=128, sample=False, seed=0, kv_dtype="bf16",
                           device="cuda")
    counts = dispatch.launch_counts()
    unfinished = [r.rid for r in trace if len(r.tokens) != r.max_new]
    if rep["requests"] != len(trace) or unfinished:
        raise AssertionError(f"engine: requests {unfinished} did not finish")
    if not rep["logits_finite"]:
        raise AssertionError("engine: non-finite logits")
    if min(counts.values()) <= 0:
        raise AssertionError(f"engine: a kernel never launched: {counts}")
    print("engine yi-6b full width x 32 layers: " + json.dumps({
        k: rep[k] for k in ("requests", "generated_tokens", "prefill_tokens",
                            "wall_s", "tokens_per_s", "decode_tokens_per_s",
                            "prefill_wall_s", "ttft_s", "latency_s",
                            "warmup_s", "logits_finite")}))
    print(f"engine peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"engine kernel launches {json.dumps(counts)}")
    return counts, cfg, params


def _profile(label, fn):
    """Device busy share of ``fn`` from a torch.profiler trace: the summed
    time of the kernels it ran (one stream, so they do not overlap) over
    its wall time, and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
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
          f"{busy / wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"profile {label}:   {e.self_device_time_total / 1e3:8.2f} ms"
              f" x{e.count:<5d} {e.key[:90]}")


def profile_engine(cfg, params):
    """Where a full-width engine step spends its time: one admission of
    four prompts (chunked prefill) and eight decode steps of four slots."""
    from repro_torch.launch import serve
    eng = serve.ServeEngine(cfg, params, n_slots=4, cache_len=1024,
                            chunk=128, sample=False, kv_dtype="bf16",
                            device="cuda")
    reqs = iter(serve.gen_trace(8, vocab=cfg.vocab_size,
                                prompt_range=(64, 600), gen_range=(64, 64),
                                arrival_rate=0.0, seed=1))
    # each call admits four fresh requests into the four slots
    _profile("admission of 4 prompts", lambda: eng.admit(
        [(next(reqs), j) for j in range(4)], 0.0))
    for _ in range(2):
        eng.decode_step_all()

    def decode():
        for _ in range(8):
            eng.decode_step_all()
    _profile("8 decode steps x 4 slots", decode)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); nothing was run")
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
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("ptxas " + line.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    records = [check_rmsnorm(gen, flush), check_append(gen, flush),
               check_decode(gen, flush)]
    for r in records:
        print(f"kernel {r['name']} [{r['shape']}]: kernel_ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"plain_ms={r['plain_ms']:.4f} library_ms="
              f"{r['library_ms']:.4f}")

    check_model_small()
    counts, cfg, params = run_yi6b_engine()
    profile_engine(cfg, params)
    by_op = {"rmsnorm_fwd": "rmsnorm",
             "flash_attention_append": "flash_append",
             "decode_attention_fwd": "decode_attention"}
    for r in records:
        r["launches"] = counts[by_op[r["name"]]]
        del r["shape"]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
