#!/usr/bin/env python3
"""Where an RL round's wall goes on the card: the threefry hashes of the
rollout replayed as CUDA graphs against the same hashes launched op by op.

  python3 chip_rl_rounds.py [pairs]

A round of the paper's asynchronous loop is eager PyTorch, and each key
split or draw of its rollout hashes a few counters a worker through ~140
elementwise kernels.  ``core/prng.py`` replays a CUDA graph of the hash
for draws of up to ``prng.GRAPH_MAX`` elements; this script sets that
bound to 0 (every hash launched op by op) or keeps it, alternating which
goes first in each of ``pairs`` pairs (5 unless given), and times two
configurations of ``chip_smoke.py`` phase 9: the paper's conv + LSTM net
on 84 x 84 Catch with 16 Hogwild workers (10 rounds after 2 warm-up
rounds), and the quickstart's MLP agent with 8 workers (200 rounds).
Round walls are host-clock times of rounds that end in a device sync
(the loss read back).  Needs one card; prints one JSON line a run and a
summary of medians and quartiles per setting.
"""
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _quickstart_round(dev):
    from repro_torch.core import prng
    from repro_torch.examples import quickstart
    init_state, round_fn = quickstart.build(dev)

    def advance(st):
        st, m = round_fn(st)
        return st, m["loss"]
    return init_state(prng.key(1)), advance


def _time(state, advance, warm, rounds):
    for _ in range(warm):
        state, _ = advance(state)
    walls = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, loss = advance(state)
        float(loss)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_rl_rounds: no CUDA device")
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.kernels import build
    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    build.library()
    graph_max = prng.GRAPH_MAX
    settings = {"graphed": graph_max, "op_by_op": 0}
    runs = {name: {"paper_net_ms": [], "quickstart_ms": []}
            for name in settings}
    for p in range(pairs):
        order = list(settings) if p % 2 == 0 else list(settings)[::-1]
        for name in order:
            prng.GRAPH_MAX = settings[name]
            state, advance, _ = cs._paper_make(cs.PAPER_WORKERS)("cuda",
                                                                 None)
            paper = statistics.median(_time(state, advance, 2, 10))
            quick = statistics.median(_time(*_quickstart_round("cuda"), 2,
                                            200))
            runs[name]["paper_net_ms"].append(paper)
            runs[name]["quickstart_ms"].append(quick)
            print(json.dumps({"pair": p, "hashes": name,
                              "paper_net_round_ms": paper,
                              "quickstart_round_ms": quick}), flush=True)
    prng.GRAPH_MAX = graph_max
    summary = {}
    for name, r in runs.items():
        for metric, xs in r.items():
            q = statistics.quantiles(xs, n=4, method="inclusive") \
                if len(xs) > 1 else xs * 3
            summary[f"{name}_{metric}"] = {
                "median": statistics.median(xs), "q1": q[0], "q3": q[2],
                "runs": xs}
    print(json.dumps({"summary": summary}))


if __name__ == "__main__":
    main()
