#!/usr/bin/env python3
"""What holds the RMSNorm kernels on the card: a sweep of their row
pipeline.

  python3 chip_rmsnorm_sweep.py

Builds ``csrc/rmsnorm.cu`` and ``csrc/rmsnorm_bwd.cu`` once for each
stage count of the row pipeline (``rn::kStages`` in
``csrc/rmsnorm_rows.cuh``: the row in hand plus kStages - 1 rows in
flight), from copies of the sources under ``build/``, and times the
forward at the train (4096 x 4096 bf16, with rstd), prefill (512 rows) and
decode (4 rows) shapes and the backward at the train shape, for each
stage count and 2, 3 or 4 blocks an SM (``rmsnorm_cuda.BLOCKS_PER_SM``),
twice over, beside ``F.rms_norm`` and its backward.  Then the cost of
summing the backward's 256 partial rows with ``torch.sum``, which the
kernel's own second launch replaced.  Times are medians of CUDA-event
timings with the L2 flushed before each call (``chip_smoke._time_ms``).
Needs one card; prints one JSON line per configuration.
"""
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STAGES = (2, 3, 4, 6)
BLOCKS_PER_SM = (2, 3, 4)


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("chip_rmsnorm_sweep: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import build, ref, rmsnorm_cuda

    build.SOURCES = ("rmsnorm.cu", "rmsnorm_bwd.cu")
    build._SIGNATURES = {k: v for k, v in build._SIGNATURES.items()
                         if k.startswith("rt_rmsnorm")}
    libs = {}
    for stages in STAGES:
        src = ROOT / "build" / "rmsnorm_sweep" / f"stages{stages}"
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", src)
        rows = src / "rmsnorm_rows.cuh"
        text = rows.read_text()
        assert "constexpr int kStages = 3;" in text
        rows.write_text(text.replace("constexpr int kStages = 3;",
                                     f"constexpr int kStages = {stages};"))
        build.CSRC, build._lib = src, None
        libs[stages] = build.library()

    flush = torch.empty(512 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = 4096
    xs = {n: torch.randn((n, d), generator=gen, device="cuda").bfloat16()
          for n in (4096, 512, 4)}
    dy = torch.randn((4096, d), generator=gen, device="cuda").bfloat16()
    scale = torch.randn((d,), generator=gen, device="cuda") * 0.5 + 1.0
    _, rstd = ref.rmsnorm_ref(xs[4096], scale, save_residuals=True)
    w16 = scale.bfloat16()
    xl = xs[4096].clone().requires_grad_(True)
    wl = w16.clone().requires_grad_(True)
    yl = F.rms_norm(xl, (d,), wl, 1e-6)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    print(json.dumps({"library_ms": {
        "fwd_train": cs._time_ms(
            lambda: F.rms_norm(xs[4096], (d,), w16, 1e-6), flush),
        "fwd_prefill": cs._time_ms(
            lambda: F.rms_norm(xs[512], (d,), w16, 1e-6), flush),
        "fwd_decode": cs._time_ms(
            lambda: F.rms_norm(xs[4], (d,), w16, 1e-6), flush),
        "bwd_train": cs._time_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True), flush)}}), flush=True)
    for rep in range(2):
        for stages in STAGES:
            build._lib = libs[stages]
            for bps in BLOCKS_PER_SM:
                rmsnorm_cuda.BLOCKS_PER_SM = bps
                ms = {
                    "fwd_train": cs._time_ms(lambda: rmsnorm_cuda.rmsnorm_fwd(
                        xs[4096], scale, save_residuals=True), flush),
                    "fwd_prefill": cs._time_ms(
                        lambda: rmsnorm_cuda.rmsnorm_fwd(xs[512], scale),
                        flush),
                    "fwd_decode": cs._time_ms(
                        lambda: rmsnorm_cuda.rmsnorm_fwd(xs[4], scale),
                        flush),
                    "bwd_train": cs._time_ms(lambda: rmsnorm_cuda.rmsnorm_bwd(
                        xs[4096], scale, rstd, dy), flush)}
                print(json.dumps({"rep": rep, "stages": stages,
                                  "blocks_per_sm": bps, "ms": ms}),
                      flush=True)
    rmsnorm_cuda.BLOCKS_PER_SM = 2
    n, _, _ = rmsnorm_cuda.row_plan(4096, d, 2, build.sm_count(0))
    part = torch.randn((n, d), device="cuda")
    print(json.dumps({"torch_sum_of_partials_ms": {
        "rows": n, "flushed": cs._time_ms(lambda: part.sum(dim=0), flush),
        "in_l2": cs._time_ms(lambda: part.sum(dim=0),
                             torch.empty(0, device="cuda"))}}))


if __name__ == "__main__":
    main()
