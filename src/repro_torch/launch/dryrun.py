"""The planner: what each rank of the reference's production mesh would
hold for every (architecture x input shape), on the meta device, with no
card and no ranks.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cases
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Options: ``--no-fsdp`` (train and prefill weights over "model" only),
``--mode delayed`` (the train step's delayed sync: each pod holds a copy,
FSDP and TP inside it, ``fsdp.layout(pod_groups=True)``; needs
``--multi-pod``), ``--out F`` (append the records to F as JSON lines;
nothing is written otherwise).

The reference (``repro/launch/dryrun.py``) lowers and compiles each case
on 512 placeholder XLA devices.  The port has no compiler to ask, so it
plans: for each case it lays out, at the production mesh's sizes
(``launch/mesh.py::production_mesh``), the shards one rank holds --

* the weights: the FSDP and tensor-parallel layout (``fsdp.layout``) for
  train and prefill, f32 masters; for decode the serving layout
  (``fsdp.serve_layout``: bf16 matrices over "model" only, no FSDP);
* the optimizer state (train: shared RMSProp's g, the weights' layout);
* the batch (``sharding.batch_shardings``);
* the decode cache (``sharding.cache_shardings`` under ``decode_rules``:
  context-parallel over "model", or over data and "model" for batch 1)

-- and prints one JSON record a case with the reference's keys where they
have a counterpart: ``arch``, ``variant``, ``shape``, ``kind``, ``mesh``,
``mode``, ``status``, ``params``, ``active_params``, ``model_flops``,
``hbm_bytes_per_chip`` (``traffic.hbm_bytes``), ``roofline``
(``hlo_analysis.roofline_terms`` at the H100's rates), ``memory`` (a
rank's bytes by part, their total and whether it ``fits`` in a card's 80
GB, stamped with the card) and, for decode, ``decode_layout``.

What it does not report, and why:

* ``hlo_flops`` and ``useful_flops_ratio``: no HLO; the compute term
  ``t_compute`` is taken from ``model_flops``;
* ``t_lower_s``, ``t_compile_s``: nothing is lowered or compiled;
* ``collective_bytes`` and ``t_collective``: null, since a step that is
  not run moves nothing (the port's collectives are counted when a step
  runs: ``distributed/collectives.py``);
* activations and workspace: ``memory`` counts what a rank holds
  between steps, not a step's temporaries.

A case is ``skipped`` where the reference skips it (Whisper at
``long_500k``), and would be ``refused`` where ``sharding.tp_refusal``
refuses the layout, with its reason; no case of the production meshes
is: ``--all`` plans 39 ok / 1 skipped / 0 refused of 40.  Minicpm-2b's
36, llama4-scout's 40 and whisper-base's 8 q heads do not divide the
16-way model axis: their attention takes the sequence arm (train,
prefill) or the column arm (decode), whose held weights the memory
record counts (``fsdp.layout``'s ``Layout.seq``); Whisper's 1500 encoder
frames are padded to 1504 over it.  xlstm-1.3b's 4 mLSTM/sLSTM heads are
split over groups of 4 ranks (``Layout.head_split``): the memory record
counts the sLSTM's ``r`` a head a rank, and the decode cache the mLSTM's
``C`` on the rank's v rows, its ``n``/``m`` and the sLSTM's states whole
on the head's 4 ranks (``sharding.Grouped``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.distributed import ctx, fsdp, sharding
from repro_torch.launch import hlo_analysis, specs, traffic
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M


def _shard_bytes(shape, spec, mesh, itemsize: int) -> int:
    n = math.prod(shape)
    for ax in spec:
        n //= sharding.entry_parts(mesh, ax)
    return n * itemsize


def param_bytes(lay: fsdp.Layout, *, serving: bool, cfg) -> int:
    """A rank's bytes of the weights held as ``lay`` says: f32 masters, or
    the serving weights (matrices in the compute dtype, vectors f32)."""
    small = M.compute_dtype(cfg).itemsize if serving else 4
    return sum(_shard_bytes(shape, lay.held[path], lay.mesh,
                            small if len(shape) >= 2 else 4)
               for path, shape in lay.shapes.items())


def tree_bytes(specs_: Dict[str, tuple], tree, mesh) -> int:
    """A rank's bytes of the tensor leaves of ``tree`` laid out by
    ``specs_`` ({path: spec}); a tensor shared by several paths counts
    once."""
    seen = set()
    total = 0
    for path, t in M.flatten(tree).items():
        if not torch.is_tensor(t) or id(t) in seen:
            continue
        seen.add(id(t))
        total += _shard_bytes(tuple(t.shape), specs_[path], mesh,
                              t.element_size())
    return total


def _model_flops(cfg, shape_id: str, kind: str) -> float:
    sh = specs.INPUT_SHAPES[shape_id]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6 * n_active * sh["batch"] * sh["seq"]
    if kind == "prefill":
        return 2 * n_active * sh["batch"] * sh["seq"]
    return 2 * n_active * sh["batch"]


def plan_case(arch: str, shape_id: str, *, multi_pod: bool = False,
              fsdp_on: bool = True, mode: str = "sync") -> dict:
    """One case's record (see the module docstring)."""
    base_cfg = get_config(arch)
    cfg = specs.maybe_long_variant(base_cfg, shape_id)
    mesh = mesh_mod.production_mesh(multi_pod=multi_pod)
    kind = specs.INPUT_SHAPES[shape_id]["kind"]
    rec = {"arch": arch, "variant": cfg.name, "shape": shape_id,
           "kind": kind, "mesh": "2x16x16" if multi_pod else "16x16",
           "mode": mode}
    if shape_id == "long_500k" and specs.LONG_DECODE.get(base_cfg.name) \
            is None:
        return {**rec, "status": "skipped",
                "reason": "encoder-decoder: its decoder's context is "
                          "bounded, so it has no long-context decode"}
    why = sharding.tp_refusal(cfg, mesh)
    if why:
        return {**rec, "status": "refused", "reason": why}
    if mode == "delayed" and not multi_pod:
        raise ValueError("the delayed mode merges over the pod axis: "
                         "pass --multi-pod")
    n_chips = ctx.mesh_devices(mesh)
    bsz = specs.INPUT_SHAPES[shape_id]["batch"]
    _, inputs = specs.input_specs(cfg, shape_id)
    memory: Dict[str, Optional[int]] = {}
    if kind == "decode":
        lay = fsdp.serve_layout(cfg, mesh)
        memory["params"] = param_bytes(lay, serving=True, cfg=cfg)
        memory["optimizer"] = 0
        memory["batch"] = tree_bytes(sharding.batch_shardings(
            mesh, inputs["batch"], batch_size=bsz), inputs["batch"], mesh)
        memory["cache"] = tree_bytes(sharding.cache_shardings(
            cfg, mesh, inputs["cache"], batch_size=bsz), inputs["cache"],
            mesh)
        rule = sharding.decode_rules(cfg, mesh,
                                     batch_size=bsz)["decode_cp"]
        rec["decode_layout"] = {"seq_axes": list(rule["seq_axes"]),
                                "batch_axes": list(rule["dp_axes"]),
                                "n_shards": rule["n_shards"]}
    else:
        delayed = kind == "train" and mode == "delayed"
        lay = fsdp.layout(cfg, mesh, fsdp=fsdp_on, pod_groups=delayed)
        memory["params"] = param_bytes(lay, serving=False, cfg=cfg)
        memory["optimizer"] = memory["params"] if kind == "train" else 0
        b_mesh = {a: n for a, n in mesh.items() if a != "pod"} \
            if delayed else mesh
        rows = bsz // mesh["pod"] if delayed else bsz
        memory["batch"] = tree_bytes(sharding.batch_shardings(
            b_mesh, inputs, batch_size=rows), {
                k: torch.empty((rows,) + tuple(t.shape[1:])
                               if k != "positions" else
                               (3, rows) + tuple(t.shape[2:]),
                               dtype=t.dtype, device="meta")
                for k, t in inputs.items()} if delayed else inputs, b_mesh)
        memory["cache"] = 0
    memory["total"] = sum(memory.values())
    memory["fits"] = memory["total"] <= mesh_mod.HBM_BYTES
    memory["card"] = mesh_mod.DEVICE
    flops = _model_flops(cfg, shape_id, kind)
    hbm = traffic.hbm_bytes(cfg, shape_id, kind, n_chips)
    terms = hlo_analysis.roofline_terms(
        hlo_flops=flops, hbm_bytes=hbm, collective_total=0.0,
        n_chips=n_chips, peak_flops=mesh_mod.PEAK_FLOPS_BF16,
        hbm_bw=mesh_mod.HBM_BW, ici_bw=mesh_mod.NVLINK_BW)
    terms["t_collective"] = None
    terms["dominant"] = "compute" if terms["t_compute"] >= \
        terms["t_memory"] else "memory"
    rec.update({"status": "ok", "params": cfg.param_count(),
                "active_params": cfg.active_param_count(),
                "model_flops": flops, "hbm_bytes_per_chip": hbm,
                "collective_bytes": None, "roofline": terms,
                "memory": memory})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="arch id (e.g. qwen2-72b); default: all")
    ap.add_argument("--shape", default=None,
                    choices=list(specs.INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--mode", default="sync", choices=["sync", "delayed"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch and/or --shape, or --all")
    archs = [args.arch] if args.arch else list(ALIASES)
    shapes = [args.shape] if args.shape else list(specs.INPUT_SHAPES)
    counts = {"ok": 0, "skipped": 0, "refused": 0, "error": 0}
    for arch in archs:
        for shape in shapes:
            try:
                rec = plan_case(arch, shape, multi_pod=args.multi_pod,
                                fsdp_on=not args.no_fsdp, mode=args.mode)
            except Exception as e:  # noqa: BLE001 -- reported, counted
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if args.multi_pod else "16x16",
                       "status": "error", "error": str(e)[:2000]}
            counts[rec["status"]] += 1
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    total = sum(counts.values())
    print(f"{counts['ok']} ok / {counts['skipped']} skipped / "
          f"{counts['refused']} refused / {counts['error']} failed of "
          f"{total}", file=sys.stderr)
    return 0 if counts["error"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
