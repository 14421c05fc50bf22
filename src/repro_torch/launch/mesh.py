"""Meshes of ranks, as ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group, one rank a device: axes ("data", "model"), or
("pod", "data", "model") when its shape has three dims.  The process group
must exist already (``sharding.process_group``); the mesh only lays its
ranks out.

The plan functions of ``distributed/sharding.py`` need only a mesh's axis
sizes, so they also take a plain {axis: size} dict: ``production_mesh``
gives the reference's production meshes ((data 16, model 16) and (pod 2,
data 16, model 16)) so, without their 256 or 512 ranks, for the planner
(``launch/dryrun.py``).

The roofline constants below are the H100's (NVIDIA H100 80GB HBM3, SXM,
700 W, from its data sheet), for the planner's roofline terms; the
reference's are a TPU v5e's and are not copied.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


# roofline constants: NVIDIA H100 80GB HBM3, 700 W, datasheet
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12              # device-memory bytes/s a card
NVLINK_BW = 450e9             # NVLink bytes/s a card, each way
HBM_BYTES = 80 * 10**9        # device memory a card
DEVICE = "NVIDIA H100 80GB HBM3, 700 W, datasheet"


def production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as {axis: size}: (data 16, model
    16), or (pod 2, data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def axis_names(ndim: int) -> Tuple[str, ...]:
    if ndim == 2:
        return ("data", "model")
    if ndim == 3:
        return ("pod", "data", "model")
    raise ValueError(f"a mesh has 2 or 3 dims, got {ndim}")


def make_mesh(shape: Tuple[int, ...], device=None):
    """A mesh of ``shape`` over every rank of the default process group, on
    ``device``'s type (the card unless asked for the CPU); the product of
    ``shape`` must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve
    dev = resolve(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=axis_names(len(shape)))


def make_debug_mesh(*, data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over data x model ranks."""
    return make_mesh((data, model), device)


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for the card (made current),
    the CPU as asked."""
    import os

    from repro_torch.device import resolve
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
