"""Meshes of ranks, as ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the default process group, one rank a device: axes ("data", "model"), or
("pod", "data", "model") when its shape has three dims.  The process group
must exist already (``sharding.process_group``); the mesh only lays its
ranks out.

The plan functions of ``distributed/sharding.py`` need only a mesh's axis
sizes, so they also take a plain {axis: size} dict, such as the
reference's production meshes ((data 16, model 16) and (pod 2, data 16,
model 16)) without their 256 or 512 ranks.

The reference's roofline constants are a TPU v5e's and have no
counterpart here: nothing in the port plans by a peak rate, and
``chip_smoke.py`` bounds its kernels by the H100 SXM data sheet's.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
