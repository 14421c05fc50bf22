#!/usr/bin/env python3
"""Where an RL round's wall goes on the card, and two trees of the port
timed against each other in alternating pairs.

  python3 chip_rl_rounds.py [pairs]
  python3 chip_rl_rounds.py --against DIR [--pairs N] [--train-pairs M]

Without ``--against``: the threefry hashes of the rollout replayed as CUDA
graphs against the same hashes launched op by op.  A round of the paper's
asynchronous loop is eager PyTorch, and each key split or draw of its
rollout hashes a few counters a worker through ~140 elementwise kernels.
``core/prng.py`` replays a CUDA graph of the hash for draws of up to
``prng.GRAPH_MAX`` elements; this mode sets that bound to 0 (every hash
launched op by op) or keeps it, alternating which goes first in each of
``pairs`` pairs (5 unless given).

With ``--against DIR``: this checkout (``change``) against the checkout in
DIR (``base``, e.g. the parent commit unpacked with ``git archive`` into a
directory that .gitignore lists), each measurement a process of its own
that imports the port from one tree and builds that tree's kernels (the
RL set-up from that tree's ``chip_smoke.py``, the train set-up from this
checkout's); the order alternates (base, change, then change, base),
``N`` pairs of RL measurements (5 unless given) and ``M`` pairs of train
steps (1 unless given; 0 skips them).

An RL measurement times two configurations of ``chip_smoke.py`` phase 9:
the paper's conv + LSTM net on 84 x 84 Catch with 16 Hogwild workers (10
rounds after 2 warm-up rounds) and the quickstart's MLP agent with 8
workers (200 rounds), then profiles one round of each: kernels launched
(device events), host launch calls, graph replays, device busy ms and
the host operators that took the most (profiled) host time.  A
train measurement takes phase 8's step (Yi-6B at full width x 16 layers,
batch 4 x 1024): one warm-up, three timed steps and one profiled step.
Round and step walls are host-clock times of work that ends in a device
sync.  Needs one card; prints one JSON line a run and a summary of
medians and quartiles per setting.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _use_tree(tree):
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.insert(0, str(tree))


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
    return walls, state


def _profiled(fn):
    """Device kernels launched, host launch calls, graph replays and
    device busy ms of one call of ``fn`` (which ends in a device sync)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.key_averages()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    host = {e.key: e.count for e in cpu}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    host_top = sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]
    return {"kernels": sum(e.count for e in dev),
            "launch_calls": host.get("cudaLaunchKernel", 0),
            "graph_replays": host.get("cudaGraphLaunch", 0),
            "busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                    for e in top],
            # profiled host time: inflated by the profiler, read the shares
            "host_top": [[e.key[:40], e.count, e.self_cpu_time_total / 1e3]
                         for e in host_top]}


def measure_rl():
    """One RL measurement of the tree on sys.path (see the module)."""
    import chip_smoke as cs
    state, advance, _ = cs._paper_make(cs.PAPER_WORKERS)("cuda", None)
    walls, state = _time(state, advance, 2, 10)

    def paper_round():
        nonlocal state
        state, loss = advance(state)
        float(loss)
    paper_prof = _profiled(paper_round)
    qstate, qadvance = _quickstart_round("cuda")
    qwalls, qstate = _time(qstate, qadvance, 2, 200)

    def quick_round():
        nonlocal qstate
        qstate, loss = qadvance(qstate)
        float(loss)
    return {"paper_net_round_ms": statistics.median(walls),
            "paper_net_frames_per_s": cs.PAPER_WORKERS * 5e3
            / statistics.median(walls),
            "paper_net_profile": paper_prof,
            "quickstart_round_ms": statistics.median(qwalls),
            "quickstart_frames_per_s": 8 * 5e3 / statistics.median(qwalls),
            "quickstart_profile": _profiled(quick_round)}


def measure_train():
    """One train measurement of the tree on sys.path (see the module):
    phase 8's set-up from this checkout's ``chip_smoke._train_make``, so
    both trees time the same step."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_train", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, run, take_step = cs._train_make()

    def one_step():
        take_step()
        float(run["metrics"][-1]["loss"])
    one_step()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_step()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = _profiled(one_step)
    return {"train_step_ms": statistics.median(walls),
            "train_step_walls_ms": walls, "train_profile": prof}


def _worker(kind, tree):
    cmd = [sys.executable, str(ROOT / "chip_rl_rounds.py"), "--measure",
           kind, "--tree", str(tree)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{kind} on {tree} failed:\n{out.stdout[-4000:]}"
                           f"\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _summary(runs):
    summary = {}
    for name, r in runs.items():
        for metric, xs in r.items():
            if not xs:
                continue
            q = statistics.quantiles(xs, n=4, method="inclusive") \
                if len(xs) > 1 else xs * 3
            summary[f"{name}_{metric}"] = {
                "median": statistics.median(xs), "q1": q[0], "q3": q[2],
                "runs": xs}
    return summary


def against(base, pairs, train_pairs):
    """Alternating pairs of this tree and ``base``, one process each."""
    trees = {"base": Path(base).resolve(), "change": ROOT}
    metrics = ("paper_net_round_ms", "paper_net_kernels",
               "paper_net_busy_ms", "quickstart_round_ms",
               "quickstart_kernels", "quickstart_busy_ms", "train_step_ms",
               "train_busy_ms", "train_kernels")
    runs = {name: {m: [] for m in metrics} for name in trees}
    for kind, n in (("rl", pairs), ("train", train_pairs)):
        for p in range(n):
            order = ["base", "change"] if p % 2 == 0 else ["change", "base"]
            for name in order:
                rec = _worker(kind, trees[name])
                r = runs[name]
                if kind == "rl":
                    r["paper_net_round_ms"].append(rec["paper_net_round_ms"])
                    r["quickstart_round_ms"].append(
                        rec["quickstart_round_ms"])
                    for cfg in ("paper_net", "quickstart"):
                        r[f"{cfg}_kernels"].append(
                            rec[f"{cfg}_profile"]["kernels"])
                        r[f"{cfg}_busy_ms"].append(
                            rec[f"{cfg}_profile"]["busy_ms"])
                else:
                    r["train_step_ms"].append(rec["train_step_ms"])
                    r["train_busy_ms"].append(rec["train_profile"]["busy_ms"])
                    r["train_kernels"].append(rec["train_profile"]["kernels"])
                print(json.dumps({"pair": p, "tree": name, "kind": kind,
                                  **rec}), flush=True)
    print(json.dumps({"summary": _summary(runs)}))


def graphs(pairs):
    """The rollout's hashes graphed against op by op, in this process."""
    import chip_smoke as cs
    from repro_torch.core import prng
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
            paper = statistics.median(_time(state, advance, 2, 10)[0])
            quick = statistics.median(_time(*_quickstart_round("cuda"), 2,
                                            200)[0])
            runs[name]["paper_net_ms"].append(paper)
            runs[name]["quickstart_ms"].append(quick)
            print(json.dumps({"pair": p, "hashes": name,
                              "paper_net_round_ms": paper,
                              "quickstart_round_ms": quick}), flush=True)
    prng.GRAPH_MAX = graph_max
    print(json.dumps({"summary": _summary(runs)}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pairs_pos", nargs="?", type=int, default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--train-pairs", type=int, default=1)
    ap.add_argument("--measure", choices=("rl", "train"), default=None)
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_rl_rounds: no CUDA device")
    if args.measure is not None:
        _use_tree(args.tree)
        os.chdir(args.tree)
        from repro_torch.kernels import build
        build.library()
        rec = measure_rl() if args.measure == "rl" else measure_train()
        print(json.dumps(rec))
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.against is not None:
        against(args.against, args.pairs, args.train_pairs)
        return
    _use_tree(ROOT)
    from repro_torch.kernels import build
    build.library()
    graphs(args.pairs_pos if args.pairs_pos is not None else args.pairs)


if __name__ == "__main__":
    main()
