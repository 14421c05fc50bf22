"""What every run shares: the benchmark file, a cell's configuration and
traffic files, the per-layer metric readers, the process clock and the
result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
configuration and the traffic of a workload, the configuration's entry
names its file, the traffic is ``traffic/<name>.json``, its ``driver``
is ``drivers/<driver>.py`` and each per-layer metric is
``metrics/<metric name>.py``.  A new cell is new files and new entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the ``time.time()`` clock, from its start
    tick in /proc (the interpreter's own start-up counts as set-up); the
    moment this module was imported where /proc does not say."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()
PHASES: list = []


def mark(phase: str) -> None:
    """The end of a phase of set-up, on the ``time.time()`` clock."""
    PHASES.append((phase, time.time()))


def phases_text(t_start: float) -> str:
    """Each phase of set-up with its seconds, in the order they ended."""
    out, t = [], t_start
    for name, at in PHASES:
        out.append(f"{name} {at - t:.2f}")
        t = at
    return "setup phases (s): " + ", ".join(out)


class HostClock:
    """The process's own CPU seconds over the window, beside its wall: a
    host-bound loop that burns more CPU for the same work met a busier
    host."""

    def __init__(self):
        self.t0, self.cpu0 = time.perf_counter(), _cpu_s()

    def stop(self):
        self.wall = time.perf_counter() - self.t0
        self.cpu_s = _cpu_s() - self.cpu0

    def text(self) -> str:
        return (f"window host: process CPU {self.cpu_s:.2f} s in "
                f"{self.wall:.2f} s")


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise SystemExit(f"no BENCHMARK.json beside {HERE}")
    return load_json(path)


def cell(bench: dict, name: str, here: Path = None) -> dict:
    """The workload ``name`` with its configuration and traffic loaded:
    {"name", "chips", "config": file contents, "traffic": file contents,
    "end_to_end": [metric entries], "per_layer": [metric entries]}."""
    here = HERE if here is None else here
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"name": name, "chips": int(w["chips"]),
            "config": load_json(here.parent / conf["file"]),
            "traffic": load_json(here / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(here / "limits" / f"{name}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict, here: Path = None):
    here = HERE if here is None else here
    return load_module(here / "drivers" / f"{traffic['driver']}.py",
                       f"portbench_driver_{traffic['driver']}")


def reader(metric: str, here: Path = None):
    """The reader of a per-layer metric: ``metrics/<metric>.py``'s
    ``read(view) -> float or None``."""
    here = HERE if here is None else here
    mod = load_module(here / "metrics" / f"{metric}.py",
                      "portbench_metric_" + metric.replace(".", "_"))
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def metric_entry(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def select_metrics(entries: list, values: dict) -> dict:
    """The cell's metrics of one kind that the run measured, by name."""
    return {m["name"]: metric_entry(values[m["name"]], m["unit"])
            for m in entries if values.get(m["name"]) is not None}


def checks_text(checks: dict) -> list:
    """One line per compared number, beside its limit."""
    return [f"{k} {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]
