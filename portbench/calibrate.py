"""The readings that the limits of ``correct`` are set from, on the card:
the program's numbers on many seeds and the controls' on a few, in one
process (the kernel library is built once).  The benchmark's own runs
never run this.

  python3 portbench/calibrate.py --workload <name> --seeds 11,12,... \
      [--controls 11,12,13]

Prints one JSON line per seed and kind: {"seed", "kind", "numbers"}; kind
"program" is the program against the reference, "fp8" the reference
computed in float8 (``reference/lowp.py``) put in the program's place,
"half_batch" the reference on the first half of the rows (the mean over
them) in its place, and for a learner cell "bf16" the reference with
bfloat16 products in its place (a witness, not a control).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent / "src"))

from benchlib import bench  # noqa: E402


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--controls", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="measured window of a serving cell's run")
    args = ap.parse_args(argv)
    import torch
    cell = bench.cell(bench.benchmark(), args.workload)
    drv = bench.driver(cell["traffic"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, numbers in drv.calibrate(cell, seed, dev,
                                           seed in args.controls,
                                           args.seconds):
            print(json.dumps({"seed": seed, "kind": kind,
                              "numbers": numbers,
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
