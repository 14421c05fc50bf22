"""The hybrid actors' cell: a Mamba-2 / attention / MoE policy
(Granite-4.0-H) served by the engine (``launch/serve.py::ServeEngine``)
under ``drivers/rollout.py``'s closed loop of actors, with this card's
share of the experts.

What differs from ``rollout``: the configuration file's ``model`` keys
must all be the port's ``ModelConfig`` fields (a misspelt multiplier
would otherwise run another model); the weights follow
``benchlib/layout_hybrid.py``; the window's least time is
``benchlib/roofline_hybrid.py``'s; a traced stretch keeps each kernel's
launch (``benchlib/linked.py``), so that the program's ``model.ssm`` and
``model.moe`` spans own the device time of their work; and the served
tokens are judged by the layer-streamed reference
(``reference/granite_hybrid.py``), against ``token_gap``'s limit as the
Yi rollout's are.

Traffic keys: those of ``rollout``.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchlib import bench, compare, faults, linked, weights
from benchlib import layout as lay_mod
from benchlib import layout_hybrid as lay
from benchlib import roofline_hybrid as rh
from benchlib.port import check_layout
from reference import granite_hybrid as ref_hybrid

base = bench.driver({"driver": "rollout"})


def port_config(model: dict):
    """The port's ``ModelConfig`` of the file's ``model`` entry, refusing
    keys that are no field of it."""
    from repro_torch.models.config import ModelConfig
    unknown = sorted(set(model) - set(ModelConfig.__dataclass_fields__))
    if unknown:
        raise ValueError(f"model keys the program has no field for: "
                         f"{unknown}")
    kw = dict(model)
    kw["block_cycle"] = tuple(kw["block_cycle"])
    return ModelConfig(**kw)


def _dtype(model):
    return getattr(torch, model["dtype"])


def make_weights(model: dict, seed: int, dev) -> dict:
    flat = weights.make(lay.layout(model), seed, dev, _dtype(model))
    lay.fill_vectors(flat, model)
    return flat


def build(cell, seed: int, dev):
    from repro_torch.launch import serve
    model, tr = cell["config"]["model"], cell["traffic"]
    cfg = port_config(model)
    check_layout(cfg, lay.layout(model))
    params = lay_mod.unflatten(make_weights(model, seed, dev))
    bench.mark("weights")
    eng = serve.ServeEngine(
        cfg, params, n_slots=tr["slots"], cache_len=tr["cache_len"],
        chunk=tr["chunk"], sample=True, seed=seed & base.M32,
        page_size=tr["page_size"], n_pages=tr["pages"], prefix_cache=True,
        kv_dtype="bf16", admission="reserve", device=dev)
    longest = serve.Request(rid=-1, prompt=np.zeros(tr["prompt"][1], np.int32),
                            max_new=tr["gen"][1], arrival=0.0)
    bench.mark("engine")
    serve._warmup(eng, [longest])
    bench.mark("warm")
    return eng


def least_s(model: dict, loop, tr: dict) -> float:
    """The window's least time: each chunk's and decode step's
    (``roofline_hybrid``), summed."""
    total = 0.0
    for plens in loop.prefills:
        for _, _, rows, last in base._chunks(plens, tr):
            total += rh.prefill_least_s(model, rows, last)
    for keys in loop.decodes:
        total += rh.decode_least_s(model, keys)
    return total


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        fault=None) -> dict:
    model, tr = cell["config"]["model"], cell["traffic"]
    eng = build(cell, seed, dev)
    if fault is not None:
        faults.plant(eng, fault)
    loop = base.Loop(eng, base.Actors(seed, tr, model["vocab_size"]))
    base._sync(dev)
    setup_s = time.time() - t_start
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loop.start()
    host = bench.HostClock()
    t0 = loop.clock()
    wall = loop.run_for(seconds)
    t_end = t0 + wall
    host.stop()
    gaps = loop.gaps + loop.open_gaps(t_end)
    gen = sum(len(r.tokens) for r in loop.issued)
    view = SimpleNamespace(
        kind="rollout", model=model, traffic=tr, chips=1, window_s=wall,
        admit_s=loop.admit_s, ttfts=loop.ttfts(t_end),
        hybrid_least_s=least_s(model, loop, tr), trace=None, host=host)
    attempted = len(loop.issued)
    if trace:
        loop.annotate = True
        view.trace = linked.capture(
            lambda: loop.run_for(tr["trace_seconds"]),
            lambda: base._sync(dev))
        loop.annotate = False
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    judged = base.sample(loop.done, seed, tr["check_tokens"])
    del loop, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cell, seed, dev, judged)
    checks = compare.held({"token_gap": ref["served"]}, cell["limits"])
    checks["tokens_judged"] = {"value": ref["tokens"],
                               "limit": tr["check_tokens"] // 2,
                               "at_least": True}
    return {"attempted": attempted, "failed": 0,
            "correct": compare.passes(checks), "checks": checks,
            "setup_s": setup_s, "memory_peak_bytes": peak,
            "e2e": {"gen_tokens_per_s": gen / wall,
                    "itl_p95_ms": 1e3 * float(np.percentile(gaps, 95)),
                    "setup_s": setup_s},
            "view": view}


def reference(cell, seed: int, dev, judged, lowp=None) -> dict:
    model = cell["config"]["model"]
    out = ref_hybrid.gaps(model, seed, dev, judged, seed & base.M32,
                          _dtype(model), lowp=lowp)
    gc.collect()
    return out


def calibrate(cell, seed: int, dev, controls: bool, seconds: float):
    """A short window at the cell's load, then the program's widest gap
    and, with ``controls``, the float8 reference's at the same
    positions."""
    from reference import lowp
    tr = cell["traffic"]
    eng = build(cell, seed, dev)
    loop = base.Loop(eng, base.Actors(seed, tr,
                                      cell["config"]["model"]["vocab_size"]))
    loop.start()
    while len(loop.done) < 8 or loop.clock() - loop.arrive[0] < seconds:
        loop.step()
    judged = base.sample(loop.done, seed, tr["check_tokens"])
    del loop, eng
    gc.collect()
    torch.cuda.empty_cache()
    out = reference(cell, seed, dev, judged,
                    lowp.fp8 if controls else None)
    yield "program", {"token_gap": out["served"], "tokens": out["tokens"]}
    if controls:
        yield "fp8", {"token_gap": out["control"], "tokens": out["tokens"]}
