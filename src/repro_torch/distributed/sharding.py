"""Context-parallel decode layout over a ``torch.distributed`` group.

The port's share of ``repro/distributed/sharding.py``: the decode part
only.  The JAX launcher's ``--decode-cp`` builds a (data=1, model=n) mesh
whose ``decode_rules`` shard the KV cache's sequence dim over the model
axis; here that mesh is one process group over every rank, with no data
axes.  Rank r holds global cache slots [r * l_loc, (r + 1) * l_loc) of
every row; the model layer writes a new row only on the rank that owns its
slot, and the dispatch layer runs the partials kernel over the local slice
and combines the ranks with two all-reduces.

Only the divisibility rule is taken (``length % n_shards == 0``): the JAX
rule's 128-row alignment of each slice exists for the TPU's matrix unit,
and the port's kernels mask their own ragged edges.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

# one backend per device: a CUDA tensor reduces over NCCL, a CPU one over gloo
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class DecodeCPSpec(NamedTuple):
    """How the context-parallel decode lays one cache out over its ranks."""
    group: Any          # torch.distributed process group of the seq shards
    rank: int           # this process's shard within the group
    n_shards: int
    l_loc: int          # cache rows of each shard (global length / n_shards)

    @property
    def start(self) -> int:
        """First global cache slot of this rank's slice."""
        return self.rank * self.l_loc


def decode_rules(group) -> dict:
    """Context-parallel decode rule set over ``group``: the JAX launcher's
    (1, n) mesh, where every rank is a sequence shard and the batch is not
    split (so the JAX rule's data axes, picked from the config and the
    batch size, have no counterpart here)."""
    return {"decode_cp": {"group": group, "rank": dist.get_rank(group),
                          "n_shards": dist.get_world_size(group)}}


def decode_cp_spec(rule: dict, *, length: int) -> DecodeCPSpec:
    """Layout of a cache of global ``length`` under the ``decode_cp`` rule:
    the single source for the model layer's cache write, the engine's
    admission copy and the dispatch layer's combine, which must agree on
    the partitioning."""
    n = int(rule["n_shards"])
    return DecodeCPSpec(rule["group"], int(rule["rank"]), n, length // n)


def decode_cp_shard_spec(rule: dict, *, length: int
                         ) -> Tuple[Optional[DecodeCPSpec], str]:
    """(spec, "") when the rule can own a cache of global ``length``, else
    (None, reason): the length must divide into one slice per shard."""
    n = int(rule["n_shards"])
    if length % n != 0 or length < n:
        return None, (f"cache length {length} does not divide over the "
                      f"{n} sequence shards")
    return decode_cp_spec(rule, length=length), ""


def check_backend(group, device: torch.device) -> None:
    """A CUDA tensor reduces over NCCL and a CPU tensor over gloo; any other
    pairing raises (nothing switches backends quietly)."""
    want = BACKENDS.get(device.type)
    got = dist.get_backend(group)
    if got != want:
        raise ValueError(f"context-parallel decode of a {device.type} "
                         f"tensor needs a {want} process group, got {got}")


@contextlib.contextmanager
def process_group(device: torch.device):
    """The default process group for ``device``'s backend, for the body of
    the ``with``.  Under torchrun (RANK and WORLD_SIZE set) it joins the
    launched ranks through ``env://``; otherwise it is a group of one over a
    ``file://`` store in a fresh temporary directory.  A group that already
    exists is checked against the device and left as it is."""
    if dist.is_initialized():
        check_backend(None, device)
        yield dist.group.WORLD
        return
    backend = BACKENDS[device.type]
    tmp = None
    try:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
            dist.init_process_group(
                backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                rank=0, world_size=1)
        yield dist.group.WORLD
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
