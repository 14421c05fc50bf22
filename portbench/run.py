"""Run one cell of the port's benchmark and print its result line.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, limits,
driver and per-layer readers are found by name (``benchlib/bench.py``).
The result is the last line of standard output, one JSON object; the
numbers that decide ``correct`` are also the last lines of standard
error, after the set-up's phases and what the host gave the window.

Exit codes: 0 a result was printed (``correct`` may be false); 2 no such
workload or no BENCHMARK.json; 3 no card, or fewer than the cell asks
for; 4 a module of JAX or of the JAX package was loaded; 1 any other
failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import bench  # noqa: E402

T_START = bench.process_start()


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    only a cell's first run there builds.  The port builds its kernel
    library under ``build/kernels`` itself."""
    cache = root / "build" / "portbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    _cache_dirs(bench.ROOT)
    try:
        cell = bench.cell(bench.benchmark(), args.workload)
    except (SystemExit, FileNotFoundError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    bench.mark("import")
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {have}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(bench.ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    bench.mark("cuda")
    out = bench.driver(cell["traffic"]).run(
        cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    line = result_line(cell, args, out, dev)
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the benchmark runs without JAX "
              "and the JAX package", file=sys.stderr)
        return 4
    print(bench.phases_text(T_START), file=sys.stderr)
    host = getattr(out["view"], "host", None)
    if host is not None:
        print(host.text(), file=sys.stderr)
    for text in bench.checks_text(line["checks"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def result_line(cell, args, out, dev) -> dict:
    import torch
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"]}
    view = out["view"]
    if args.trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = bench.reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = bench.metric_entry(v, m["unit"])
        device["busy_s"] = view.trace.busy_s()
        device["window_s"] = view.trace.window_s
        line["metrics"] = metrics
        line["device"] = device
        line["breakdown"] = view.trace.breakdown()
    else:
        line["metrics"] = bench.select_metrics(cell["end_to_end"], out["e2e"])
        line["device"] = device
    line["checks"] = out["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
