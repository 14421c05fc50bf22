"""The learner's cells: ``make_train_step`` (``core/llm_a3c.py``) with
Shared RMSProp, driven as the train CLI drives it (``launch/train.py``),
on the token-MDP batches of ``benchlib/tokenmdp.py``, on one card.

Set-up builds one train step with its model and optimizer state from the
seed and takes its first three steps through the window's own call and
feed; the program's readings for ``correct`` are taken there (each
step's loss, the first gradient's norms from the RMSProp state after one
step, the parameters' change after the first step and after
``ref_steps``).  The window then runs whole steps until
``seconds`` have passed, each ending in a device sync.  After the window
the program's state is freed and the reference follows the first
``ref_steps`` steps from the same weights and batches.

Traffic keys: rows and seq (the batch), lr0, total_steps, alpha,
eps, ref_steps, trace_steps (steps in the profiled stretch of a traced
run).
"""
from __future__ import annotations

import gc
import math
import time
from types import SimpleNamespace

import torch

from benchlib import bench, compare, devtrace, faults, roofline, tokenmdp
from benchlib import weights
from benchlib import layout as lay_mod
from benchlib.port import check_layout, port_config
from reference import model as ref_model
from reference import train as ref_train

WARM_STEPS = 3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaf_sums(flat: dict) -> dict:
    """{path: sum of the leaf's elements}."""
    paths = list(flat)
    sq = torch.stack([flat[p].detach().double().sum() for p in paths])
    return dict(zip(paths, sq.tolist()))


class Program:
    """The system under test: the train step, its parameters and state."""

    def __init__(self, cell, seed, dev, fault=None):
        from repro_torch.core import llm_a3c
        from repro_torch.models import model as M
        from repro_torch.optim import optimizers as opt_mod
        self.M = M
        tr = cell["traffic"]
        self.model = cell["config"]["model"]
        self.cfg = port_config(self.model)
        self.lay = lay_mod.layout(self.model)
        check_layout(self.cfg, self.lay)
        self.rows, self.seq = tr["rows"], tr["seq"]
        self.seed, self.dev, self.tr = seed, dev, tr
        params = lay_mod.unflatten(weights.make(self.lay, seed, dev))
        bench.mark("weights")
        self.opt = opt_mod.shared_rmsprop(alpha=tr["alpha"], eps=tr["eps"])
        self.params = params
        self.state = self.opt.init(params)
        step = llm_a3c.make_train_step(self.cfg, self.opt, lr0=tr["lr0"],
                                       total_steps=tr["total_steps"])
        self.step_fn = faults.train_step(step, fault, self.cfg, self.rows) \
            if fault else step
        self.i = 0
        self.metrics = []

    def batch(self, i):
        return tokenmdp.batch(self.seed, i, rows=self.rows, seq=self.seq,
                              vocab=self.model["vocab_size"],
                              device=self.dev,
                              gamma=self.tr.get("gamma", 0.99))

    def step(self):
        self.params, self.state, met = self.step_fn(
            self.params, self.state, self.batch(self.i), self.i)
        self.metrics.append(met["loss"].detach())
        self.i += 1

    def grad_norms(self):
        """The first gradient's norms, from the RMSProp state after one
        step: g = (1 - alpha) grad^2 from a state of zeros."""
        sq = _leaf_sums(self.M.flatten(self.state["g"]))
        a = self.tr["alpha"]
        return {p: math.sqrt(v / (1.0 - a)) for p, v in sq.items()}

    def change_norms(self):
        return weights.change_norms(self.lay, self.seed,
                                    self.M.flatten(self.params))

    def close(self):
        del self.params, self.state, self.step_fn
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        fault=None) -> dict:
    tr = cell["traffic"]
    prog = Program(cell, seed, dev, fault)
    bench.mark("built")
    ref_steps = tr["ref_steps"]
    readings = {}
    for _ in range(max(WARM_STEPS, ref_steps)):
        prog.step()
        if prog.i == 1:
            readings["grad_norms"] = prog.grad_norms()
            readings["change1_norms"] = prog.change_norms()
        if prog.i == ref_steps:
            readings["change_norms"] = prog.change_norms()
    _sync(dev)
    bench.mark("warm")
    readings["losses"] = [float(x) for x in prog.metrics[:ref_steps]]
    setup_s = time.time() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    host = bench.HostClock()
    n, t0 = 0, time.perf_counter()
    while True:
        prog.step()
        n += 1
        _sync(dev)
        wall = time.perf_counter() - t0
        if wall >= seconds:
            break
    host.stop()
    losses = [float(x) for x in prog.metrics[-n:]]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tokens = prog.rows * prog.seq
    view = SimpleNamespace(
        kind="train", model=prog.model, traffic=tr, chips=1,
        window_s=wall, steps=n,
        step_flops=roofline.train_step_flops(
            prog.model, prog.rows, prog.seq,
            lay_mod.product_params(prog.model)),
        trace=None, trace_steps=0, host=host)
    if trace:
        _traced(prog, view, dev)
    prog.close()
    del prog
    ref = reference(cell, seed, dev)
    numbers = compare.train_numbers(readings, ref)
    checks = compare.held(numbers, cell["limits"])
    failed = sum(1 for x in losses if not math.isfinite(x))
    return {"attempted": n, "failed": failed,
            "correct": compare.passes(checks) and failed == 0,
            "checks": checks, "setup_s": setup_s, "memory_peak_bytes": peak,
            "e2e": {"train_tokens_per_s": tokens * n / wall,
                    "setup_s": setup_s},
            "view": view}


def _traced(prog, view, dev):
    """A profiled stretch of ``trace_steps`` steps after the window."""
    k = prog.tr["trace_steps"]

    def steps():
        for _ in range(k):
            with torch.profiler.record_function("portbench.step"):
                prog.step()
    view.trace = devtrace.capture(steps, lambda: _sync(dev))
    view.trace_steps = k


def _batches(tr, model, seed, dev, rows=None):
    rows = tr["rows"] if rows is None else rows
    return [tokenmdp.rows_of(
        tokenmdp.batch(seed, i, rows=tr["rows"], seq=tr["seq"],
                       vocab=model["vocab_size"], device=dev,
                       gamma=tr.get("gamma", 0.99)), 0, rows)
        for i in range(tr["ref_steps"])]


def reference(cell, seed: int, dev, kind=None) -> dict:
    """The reference's readings: the first ``ref_steps`` steps from the
    seed's weights on the seed's batches.  With ``kind`` it stands in the
    program's place: computed in float8 (``fp8``, the control) or in
    bfloat16 (``bf16``, a witness), or on the first half of the rows, the
    mean over them (``half_batch``, a fault)."""
    from reference import lowp
    ref_model.exact()
    tr, model = cell["traffic"], cell["config"]["model"]
    lay = lay_mod.layout(model)
    f = weights.make(lay, seed, dev)
    rows = tr["rows"] // 2 if kind == "half_batch" else None
    first = {}

    def after_step(step, f):
        if step == 0:
            first.update(weights.change_norms(lay, seed, f))
    out = ref_train.follow(model, f, _batches(tr, model, seed, dev, rows),
                           tr, lowp=lowp.PRECISIONS.get(kind),
                           after_step=after_step)
    out["change1_norms"] = first
    out["change_norms"] = weights.change_norms(lay, seed, f)
    del f
    gc.collect()
    return out


def program_readings(cell, seed: int, dev, fault=None) -> dict:
    """The program's readings of set-up alone (no window)."""
    prog = Program(cell, seed, dev, fault)
    ref_steps = cell["traffic"]["ref_steps"]
    out = {}
    for _ in range(ref_steps):
        prog.step()
        if prog.i == 1:
            out["grad_norms"] = prog.grad_norms()
            out["change1_norms"] = prog.change_norms()
    out["change_norms"] = prog.change_norms()
    out["losses"] = [float(x) for x in prog.metrics]
    prog.close()
    return out


CONTROLS = ("fp8", "half_batch", "bf16")


def calibrate(cell, seed: int, dev, controls: bool, seconds: float):
    """The program's readings against the reference's, and with
    ``controls`` the float8 control's, the half-batch fault's and the
    bfloat16 witness's in the program's place."""
    prog = program_readings(cell, seed, dev)
    ref = reference(cell, seed, dev)
    yield "program", compare.train_readings(prog, ref)
    if controls:
        for kind in CONTROLS:
            got = reference(cell, seed, dev, kind)
            yield kind, compare.train_readings(got, ref)
