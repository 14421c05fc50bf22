"""Sharding over a mesh of ``torch.distributed`` ranks, as
``repro/distributed/sharding.py``.

Mesh axes (``launch/mesh.py``):
  pod    -- outer replica groups (the delayed-sync merge axis)
  data   -- batch and FSDP axis
  model  -- tensor parallelism: heads, d_ff, vocab, experts

*The plan* (``param_shardings``, ``batch_shardings``,
``opt_state_shardings`` and ``activation_rules``) is the reference's,
name by name: for each parameter leaf a tuple of mesh-axis names, one
per dim ("data", "model", a tuple of axes, or None for a dim held whole),
from the same path regexes (matched on the port's "." path joined with
"/"), the same resolution and the same rule that drops an axis that does
not divide its dim.  The reference plans scan-stacked leaves with a
leading layer dim; the port's layer i takes the stacked spec without it.  The plan only
needs the mesh's axis sizes, so it takes a ``DeviceMesh`` or an
{axis: size} dict.  How the port holds the plan is ``fsdp.py``'s: the
experts' "model" entries, and under tensor parallelism each dense "model"
entry that ``tp_holds`` keeps; every other "model" entry is held whole on
each rank of the model axis.

*Tensor and sequence parallelism* (slice 6b-i): ``activation_rules`` gives
the reference's layout entries ("residual", "attn_q", "attn_kv") as spec
tuples.  Its "attn_q" and "attn_kv" entries decide the heads:
``tp_holds`` splits wk and wv only where the kv heads stay local (else
they are held whole: the whole-kv arm, a stated difference in layout
from the reference, which splits their columns).  Where "attn_q" pins
the sequence instead (q heads that do not divide the model axis), the
attention takes the sequence arm (slice 6b-iii, ``seq_attention``): each
model rank attends its rows of the sequence, wq's columns and wo's rows
held as the plan splits them, off head boundaries.
Slice 6b-ii covers every other block kind: ``tp_refusal`` names each
recurrent width that does not divide the model axis, and
``tp_splits`` says how each held leaf is split (mamba2's ``in_proj`` and
conv part by part, the sLSTM's ``r`` over its heads: stated differences
in layout, ROADMAP queue 3).  Slice 6b-iv lays out a model axis wider
than a block's heads: the xLSTM heads split over groups of ``g = tp / H``
ranks (``head_split``; rank r works on head r // g and owns a g-th of its
features, the sLSTM's ``r`` held whole on the head's g ranks, a
``Grouped`` spec entry), and the encoder-decoder on the sequence arm,
its encoder frames padded to a multiple of the axis
(``models/encdec.py``).
``attention_shard_spec`` and ``rmsnorm_shard_spec`` are the reference's
head-locality and row checks, kept for parity with it only: they decide
nothing in the port, whose kernels see each rank's local tensors.

*Groups*: ``axes_group`` gives the process group over one or more mesh
axes (several flattened, pod-major, as the reference's ('pod', 'data')
batch axes), ``axes_rank`` this rank's index in it.

*Context-parallel decode* (``decode_rules``): the reference's rule set,
in one function for every mesh.  Where the data axes divide the batch,
each data rank takes its rows and the caches' sequence dim goes over
"model"; otherwise every rank holds the whole batch and the sequence goes
over the data axes and "model" together (batch-1 long-context decode over
the whole mesh).  The sequence-shard index is data-major (``axes_group``
orders the ranks row-major over the rule's ``seq_axes``), as the
reference's ``attention.py`` computes it.  The serve engine's
``--decode-cp`` builds the JAX CLI's (data 1, model n) mesh and takes the
same rules.  Shard s of ``n_shards`` holds global cache slots
[s * l_loc, (s + 1) * l_loc) of each of its rows; the model layer writes a
new row only on the shard that owns its slot, and the dispatch layer runs
the partials kernel over the local slice and combines the shards with two
all-reduces over the ``seq_axes`` group.  Only the divisibility rule is
taken (``length % n_shards == 0``): the JAX rule's 128-row alignment of
each slice exists for the TPU's matrix unit, and the port's kernels mask
their own ragged edges.  ``cache_shardings`` gives each leaf of a decode
cache its layout under these rules: the reference's for KV caches, page
pools and page tables; the recurrent states over their heads, where the
reference puts "model" on their last dim that divides it (a stated
difference in layout, ROADMAP queue 3: the port decodes on each rank's
heads, and a rank's bytes are the same wherever both dims divide; under
the head-split arm the mLSTM's ``C`` is held on the rank's v rows of its
head, and its ``n``, ``m`` and the sLSTM's states whole on the head's g
ranks).
"""
from __future__ import annotations

import contextlib
import os
import re
import shutil
import tempfile
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

# one backend per device: a CUDA tensor reduces over NCCL, a CPU one over gloo
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class DecodeCPSpec(NamedTuple):
    """How the context-parallel decode lays one cache out over its shards:
    ``group`` the process group over ``seq_axes`` (None where the mesh has
    no ranks, a plan), ``rank`` this process's shard in it, ``batch`` the
    axes of the batch rows (None: every rank holds the whole batch)."""
    group: Any          # torch.distributed process group of the seq shards
    rank: int           # this process's shard within the group
    n_shards: int
    l_loc: int          # cache rows of each shard (global length / n_shards)
    batch: Any = None
    seq_axes: Tuple[str, ...] = ("model",)

    @property
    def start(self) -> int:
        """First global cache slot of this rank's slice."""
        return self.rank * self.l_loc


def _decode_axes(mesh, batch_size: int):
    """(batch axes or None, seq axes) of the decode layout: the batch over
    the data axes where they divide it, else the sequence over them too."""
    d_ax = data_axes(mesh)
    batch_ok = bool(d_ax) and batch_size % axes_size(mesh, d_ax) == 0
    if batch_ok:
        return d_ax, ("model",)
    return None, tuple(d_ax) + ("model",)


def decode_rules(cfg, mesh, *, batch_size: int) -> dict:
    """The context-parallel decode rule set (``repro/distributed/
    sharding.py::decode_rules``): {"decode_cp": {"mesh", "seq_axes",
    "dp_axes", "n_shards"}}, the batch over the data axes where they
    divide ``batch_size`` (``dp_axes``, empty otherwise) and the caches'
    sequence over ``seq_axes`` ("model", or the data axes and "model").
    On a ``DeviceMesh`` the rule also holds the process group over
    ``seq_axes`` and this rank's shard in it (made here, so every rank
    must call this in the same order); ``mesh`` may be an {axis: size}
    dict for a plan.  ``cfg`` is the reference's argument; the layout does
    not depend on it."""
    dp, seq_axes = _decode_axes(mesh, batch_size)
    rule = {"mesh": mesh, "seq_axes": seq_axes, "dp_axes": dp or (),
            "n_shards": axes_size(mesh, seq_axes)}
    if not isinstance(mesh, dict):
        rule["group"] = axes_group(mesh, seq_axes)
        rule["rank"] = axes_rank(mesh, seq_axes)
    return {"decode_cp": rule}


def decode_cp_spec(rule: dict, *, length: int) -> DecodeCPSpec:
    """Layout of a cache of global ``length`` under the ``decode_cp`` rule:
    the single source for the model layer's cache write, the engine's
    admission copy and the dispatch layer's combine, which must agree on
    the partitioning."""
    n = int(rule["n_shards"])
    dp = tuple(rule.get("dp_axes", ()))
    batch = None if not dp else (dp[0] if len(dp) == 1 else dp)
    return DecodeCPSpec(rule.get("group"), int(rule.get("rank", 0)), n,
                        length // n, batch,
                        tuple(rule.get("seq_axes", ("model",))))


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


# ---------------------------------------------------------------------------
# meshes and their groups
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axes_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


_GROUPS: Dict[Any, Any] = {}


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group over mesh ``axes`` that holds this rank: one axis's
    group, or for several a group over their product, ranks in row-major
    order of ``axes``.  Every rank must ask for the same axes in the same
    order (the groups are made collectively, once a mesh)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        rows = mesh.mesh.permute(order).reshape(-1, axes_size(mesh, axes))
        group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def axes_rank(mesh, axes: Tuple[str, ...]) -> int:
    """This rank's index along ``axes`` (row-major over several)."""
    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    r = 0
    for a in axes:
        r = r * shape[a] + coord[a]
    return r


def scan_stacked(cfg) -> bool:
    """The reference's rule for scan-stacked layers
    (``repro/models/model.py:218-221``): its parameter plan gives such
    layers' leaves a leading layer dim."""
    return (cfg.n_layers % len(cfg.block_cycle) == 0
            and cfg.shared_attn_every == 0
            and not cfg.is_encdec)


# ---------------------------------------------------------------------------
# parameter plan
# ---------------------------------------------------------------------------

# (regex on the "/"-joined path, spec of the unstacked leaf): "F" = the
# FSDP (data) axes, "M" = the model axis; resolved per mesh
_PARAM_RULES = [
    (r"embed/table$",              ("M", "F")),
    (r"lm_head/w$",                ("F", "M")),
    (r"value_head/w$",             ("F", None)),
    (r"(wq|wk|wv|up_x|up_z|w_in|ff_gate|ff_up)/w$", ("F", "M")),
    (r"(wo|down|ff_down|out_proj)/w$",              ("M", "F")),
    (r"(gate|up)/w$",              ("F", "M")),
    (r"(mlp/fc1|fc1)/w$",          ("F", "M")),
    (r"(mlp/fc2|fc2)/w$",          ("M", "F")),
    (r"in_proj/w$",                ("F", "M")),
    (r"(wq|wk|wv)/b$",             ("M",)),
    (r"(gate|up|fc1)/b$",          ("M",)),
    (r"router$",                   ("F", None)),
    # expert weights: over the model axis only
    (r"w_(gate|up)$",              ("M", None, None)),  # (E, d, f)
    (r"w_down$",                   ("M", None, None)),  # (E, f, d)
    (r"conv_w$",                   (None, "M")),
    (r"conv_b$",                   ("M",)),
    (r"(A_log|D|dt_bias)$",        ("M",)),
    (r"(mamba|mlstm)/norm/scale$", ("M",)),
    (r"w_[if]/w$",                 ("F", None)),
    (r"slstm/r$",                  (None, "F", "M")),   # (H, hd, 4hd)
]


def _resolve(tpl, mesh, *, fsdp: bool = True) -> tuple:
    d_ax = data_axes(mesh)
    out = []
    for s in tpl:
        if s == "M":
            out.append("model")
        elif s == "F":
            ax = d_ax if (fsdp and d_ax) else None
            out.append(ax[0] if isinstance(ax, tuple) and len(ax) == 1
                       else ax)
        else:
            out.append(None)
    return tuple(out)


def param_spec(path: str, ndim: int, mesh, *, stacked: bool,
               fsdp: bool = True) -> tuple:
    """The reference's spec of a leaf of ``ndim`` dims at ``path`` ("/"
    joined; ``ndim`` counts the layer dim of a stacked leaf), as long as
    the rule says (shorter than ``ndim`` where the rule is)."""
    for pat, tpl in _PARAM_RULES:
        if re.search(pat, path):
            spec = _resolve(tpl, mesh, fsdp=fsdp)
            if len(spec) > ndim:
                return ()                   # degenerate leaf: replicated
            if stacked and ndim == len(spec) + 1:
                return (None,) + spec
            return spec
    return ()                               # norms, small biases, scalars


class Grouped(NamedTuple):
    """A spec entry of the head-split arm: the dim split over ``axis`` in
    groups of ``g`` consecutive ranks.  ``inner`` False: the dim cut into
    n / g parts, part r // g on rank r (a head held whole on its group's g
    ranks); True: cut into g parts, part r % g on rank r (a head's
    features within its group)."""
    axis: str
    g: int
    inner: bool = False


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, an axis, a tuple of them or
    a ``Grouped`` entry)."""
    if entry is None:
        return ()
    if isinstance(entry, Grouped):
        return (entry.axis,)
    return entry if isinstance(entry, tuple) else (entry,)


def entry_parts(mesh, entry) -> int:
    """How many parts one spec entry cuts its dim into over ``mesh``."""
    n = axes_size(mesh, entry_axes(entry))
    if isinstance(entry, Grouped):
        return entry.g if entry.inner else n // entry.g
    return n


def entry_index(mesh, entry) -> int:
    """Which of ``entry_parts`` this rank holds."""
    r = axes_rank(mesh, entry_axes(entry))
    if isinstance(entry, Grouped):
        return r % entry.g if entry.inner else r // entry.g
    return r


def _divisible_spec(shape: tuple, spec: tuple, mesh) -> tuple:
    """``spec`` padded to ``shape``'s dims, each axis that does not divide
    its dim dropped (e.g. 4-head xLSTM), as ``param_shardings`` does."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if dim % axes_size(mesh, entry_axes(ax)) == 0 else None
                 for dim, ax in zip(shape, spec))


def param_shardings(cfg, mesh, shapes: Optional[Dict[str, tuple]] = None,
                    *, fsdp: bool = True) -> Dict[str, tuple]:
    """The plan: {"layers.3.attn.wq.w": ("data", "model"), ...}, one entry
    a dim, for the leaves of ``shapes`` (the port's ``param_shapes(cfg)``
    by default)."""
    if shapes is None:
        from repro_torch.models.model import param_shapes
        shapes = param_shapes(cfg)
    stacked = scan_stacked(cfg)
    out = {}
    for key, shape in shapes.items():
        path = key.replace(".", "/")
        lead = stacked and path.startswith("layers/")
        spec = param_spec(path, len(shape) + lead, mesh, stacked=lead,
                          fsdp=fsdp)
        spec = tuple(spec) + (None,) * (len(shape) + lead - len(spec))
        if lead:
            if spec[0] is not None:
                raise ValueError(f"{key}: the plan {spec} shards the layer "
                                 "dim, which the port's layer list has not")
            spec = spec[1:]
        out[key] = _divisible_spec(tuple(shape), spec, mesh)
    return out


def strip_axis(spec: tuple, axis: str) -> tuple:
    """A spec with ``axis`` taken out of every entry."""
    def strip(a):
        if isinstance(a, Grouped):
            return None if a.axis == axis else a
        if isinstance(a, tuple):
            t = tuple(x for x in a if x != axis)
            return t if len(t) > 1 else (t[0] if t else None)
        return None if a == axis else a
    return tuple(strip(a) for a in spec)


def strip_pod(spec: tuple) -> tuple:
    """The delayed-sync groups' inner layout: ``dryrun.py``'s
    ``prepend_pod`` without the prepended group dim."""
    return strip_axis(spec, "pod")


def opt_state_shardings(cfg, mesh, params_shardings: Dict[str, tuple]):
    """Optimizer state mirrors the parameter plan (g has params' shape)."""
    return {"g": params_shardings}


# ---------------------------------------------------------------------------
# batch plan and activation rules
# ---------------------------------------------------------------------------

def _batch_axis(mesh, batch_size: int):
    d_ax = data_axes(mesh)
    if not d_ax or batch_size % axes_size(mesh, d_ax) != 0:
        return None
    return d_ax[0] if len(d_ax) == 1 else d_ax


def batch_shardings(mesh, batch_tree: Dict[str, Any], *,
                    batch_size: int) -> Dict[str, tuple]:
    """The leading batch dim over the data axes (when they divide it);
    M-RoPE ``positions`` (3, B, S) on its second dim.  ``batch_tree``:
    {name: tensor or shape}."""
    dp = _batch_axis(mesh, batch_size)
    out = {}
    for name, leaf in batch_tree.items():
        ndim = len(getattr(leaf, "shape", leaf))
        if name.endswith("positions"):
            out[name] = (None, dp, None)
        else:
            out[name] = (dp,) + (None,) * (ndim - 1)
    return out


def shard_batch(mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch, as ``batch_shardings`` lays it
    out: rows [r * B / n, (r + 1) * B / n) of the data axes.  A batch the
    data axes do not divide is a ValueError (a rank cannot run the whole
    batch as the reference's one device does)."""
    d_ax = data_axes(mesh)
    n = axes_size(mesh, d_ax)
    size = next(iter(batch.values())).shape[0]
    specs = batch_shardings(mesh, batch, batch_size=size)
    if n > 1 and all(d is None for s in specs.values() for d in s):
        raise ValueError(f"batch {size} does not divide over the {n} ranks "
                         f"of the data axes {d_ax}: each rank takes "
                         "batch / n rows")
    r = axes_rank(mesh, d_ax)
    out = {}
    for name, t in batch.items():
        dim = 1 if name.endswith("positions") else 0
        rows = t.shape[dim] // n
        out[name] = t.narrow(dim, r * rows, rows)
    return out


_KV_LEAVES = ("k", "v", "ks", "vs")
_POOL_LEAVES = ("kp", "vp", "kps", "vps")


def _state_split_ok(cfg, kind: str, name: str, width: int, m: int) -> bool:
    """Whether a recurrent state's held dim splits over ``m`` model ranks:
    mamba2's conv state part by part (x | B | C, as ``tp_splits`` splits
    its conv), every other state on its heads or channels whole."""
    if kind == "mamba2" and name == "conv":
        d_inner = cfg.ssm_heads * cfg.ssm_head_dim
        gn = cfg.ssm_groups * cfg.ssm_state
        return d_inner % m == 0 and gn % m == 0
    return width % m == 0


def cache_shardings(cfg, mesh, cache, *, batch_size: int
                    ) -> Dict[str, tuple]:
    """The decode cache's layout under ``decode_rules``: {"layers.3.k":
    ("data", "model", None, None), ...}, one entry a dim, for every tensor
    leaf of ``cache`` (whole, as ``init_cache`` makes it; meta tensors
    will do).  The reference's rules (``repro/distributed/sharding.py::
    cache_shardings``):

    * K/V caches and their int8 scales (B, L, Hkv, D | 1): the batch over
      the data axes where they divide it, the sequence over the rule's
      ``seq_axes`` where they divide L (a ring of another length, and the
      encoder-decoder's cross memory alike);
    * page pools (P, page, Hkv, D | 1): the kv heads over "model" where
      the batch divides the data axes (and the heads the axis), else the
      pages over the ``seq_axes`` where they divide them;
    * page tables and scalars: replicated;
    * recurrent states: the batch as a K/V cache's, and "model" on the
      heads (mamba2's ``h``, the mLSTM's ``C``/``n``/``m``, the sLSTM's
      four) or on the conv state's channels (mamba2's part by part) where
      they divide.  The reference puts "model" on each state's last dim
      that divides it: a stated difference in layout (ROADMAP queue 3),
      the same bytes a rank wherever both dims divide.  Under the
      head-split arm (``head_split``: g ranks a head) the xLSTM states
      take ``Grouped`` entries: the mLSTM's ``C`` the rank's head and its
      hd / g v rows (the reference's bytes), its ``n`` and ``m`` and the
      sLSTM's four the head whole on its g ranks (g times the reference's
      bytes of ``n`` and the sLSTM's states)."""
    from repro_torch.models.model import flatten
    dp = _batch_axis(mesh, batch_size)
    _, seq_axes = _decode_axes(mesh, batch_size)
    seq = seq_axes[0] if len(seq_axes) == 1 else seq_axes
    n_seq = axes_size(mesh, seq_axes)
    m = mesh_shape(mesh).get("model", 1)
    kinds = cfg.layer_kinds()
    g = head_split(cfg, mesh)
    out = {}
    for path, leaf in flatten(cache).items():
        if not torch.is_tensor(leaf):
            continue
        shape = tuple(leaf.shape)
        name = path.rsplit(".", 1)[-1]
        if not shape or name == "pt":
            spec = (None,) * len(shape)
        elif name in _POOL_LEAVES:
            if dp is not None:
                heads = "model" if m > 1 and shape[2] % m == 0 else None
                spec = (None, None, heads, None)
            else:
                spec = (seq if shape[0] % n_seq == 0 else None, None, None,
                        None)
        elif name in _KV_LEAVES:
            spec = (dp, seq if shape[1] % n_seq == 0 else None, None, None)
        else:
            parts = path.split(".")
            kind = kinds[int(parts[1])] if parts[0] == "layers" else ""
            dim = len(shape) - 1 if name == "conv" else 1
            spec = [None] * len(shape)
            spec[0] = dp
            if g and kind in ("mlstm", "slstm") and name != "conv":
                spec[1] = Grouped("model", g)
                if kind == "mlstm" and name == "C":
                    spec[2] = Grouped("model", g, inner=True)
            elif _state_split_ok(cfg, kind, name, shape[dim], m):
                spec[dim] = "model"
            spec = tuple(spec)
        out[path] = spec
    return out


def activation_rules(mesh, *, batch_size: int, cfg=None) -> dict:
    """Activation rules, installed with ``ctx.sharding_rules``: the
    reference's layout entries as spec tuples, one entry a dim --
    "residual" (dp, "model", None), the Megatron-SP residual between
    blocks; "attn_q" and "attn_kv" (dp, None, "model", None), heads local
    to the model axis, or, where the config's q (kv) heads do not divide
    the model axis, the sequence dim pinned instead, (dp, "model", None,
    None) -- and for a config with experts ``moe_ep``, which picks the
    expert-parallel MoE over the model group outside tensor parallelism,
    ``dp_axes`` the data axes where they divide the batch.  The port lays
    its activations out by explicit collectives in the model layer
    (``fsdp.tp_rule``); ``tp_refusal`` and ``tp_holds`` read the head
    entries to choose that layout."""
    d_ax = data_axes(mesh)
    batch_ok = bool(d_ax) and batch_size % axes_size(mesh, d_ax) == 0
    dp = _batch_axis(mesh, batch_size)
    msize = mesh_shape(mesh)["model"]
    heads = (dp, None, "model", None)
    seq_sharded = (dp, "model", None, None)
    rules = {"residual": (dp, "model", None),
             "attn_q": heads, "attn_kv": heads}
    if cfg is not None:
        if cfg.n_heads % msize != 0:
            rules["attn_q"] = seq_sharded
        if cfg.n_kv_heads % msize != 0:
            rules["attn_kv"] = seq_sharded
    if cfg is not None and cfg.n_experts:
        rules["moe_ep"] = {"mesh": mesh, "tp": msize,
                           "dp_axes": d_ax if batch_ok else ()}
    return rules


# ---------------------------------------------------------------------------
# tensor and sequence parallelism (slice 6b-i)
# ---------------------------------------------------------------------------

class AttnShardSpec(NamedTuple):
    """``attention_shard_spec``'s layout: the batch over ``batch`` (an
    axis, a tuple of axes, or None), q and kv heads over ``heads``
    ("model" or None)."""
    batch: Any
    heads: Optional[str]


class RowShardSpec(NamedTuple):
    """``rmsnorm_shard_spec``'s layout: rows over the product of ``axes``."""
    axes: Tuple[str, ...]


def attention_shard_spec(mesh, *, batch: int, n_q_heads: int,
                         n_kv_heads: int
                         ) -> Tuple[Optional[AttnShardSpec], str]:
    """The reference's head-locality check (``repro/distributed/
    sharding.py::attention_shard_spec``): the batch over the data axes
    where they divide it, q *and* kv heads over "model" where both divide
    it, so shard j owns q heads [j hq / m, (j + 1) hq / m) and exactly the
    kv heads they read.  (spec, "") or (None, reason).  Reference parity
    only: the port decides its heads from the rules (``tp_refusal``,
    ``tp_holds``) and runs the kv heads that do not divide through the
    whole-kv arm, where this check refuses."""
    shape = mesh_shape(mesh)
    d_ax = data_axes(mesh)
    d_size = axes_size(mesh, d_ax)
    m_size = shape.get("model", 1)
    if d_size == 1 and m_size == 1:
        return AttnShardSpec(None, None), ""
    dp: Any = d_ax if (d_ax and batch % d_size == 0 and d_size > 1) \
        else None
    if isinstance(dp, tuple) and len(dp) == 1:
        dp = dp[0]
    heads = None
    if m_size > 1:
        if n_q_heads % m_size == 0 and n_kv_heads % m_size == 0:
            heads = "model"
        else:
            return None, (f"heads ({n_q_heads}q/{n_kv_heads}kv) do not "
                          f"divide the {m_size}-way model axis")
    if dp is None and heads is None:
        return None, (f"mesh axes divide neither batch={batch} "
                      f"(data={d_size}) nor heads (model={m_size})")
    return AttnShardSpec(dp, heads), ""


def _mentions(spec, axis: str, dim: int) -> bool:
    if spec is None or dim >= len(spec):
        return False
    return axis in entry_axes(spec[dim])


def rmsnorm_shard_spec(mesh, *, rows: int, rules: Optional[dict] = None
                       ) -> Tuple[Optional[RowShardSpec], str]:
    """The reference's row check (``rmsnorm_shard_spec``): rows split over
    every mesh axis of size > 1 where their product divides them into
    blocks of >= 8 rows, except under the sequence-parallel residual,
    whose rows are already split over "model" (there the port normalises
    each rank's rows where they lie).  (spec, "") or (None, reason).
    Reference parity only: under tensor parallelism the port's norms run
    on the sequence-parallel rows (``models/model.py``)."""
    shape = mesh_shape(mesh)
    names = list(shape)
    r = (rules or {}).get("residual")
    if shape.get("model", 1) > 1 and _mentions(r, "model", 1):
        return None, ("the sequence-parallel residual splits the rows over "
                      "'model' already: a row split over the mesh would "
                      "gather the residual stream again")
    axes = tuple(a for a in names if shape[a] > 1)
    if not axes:
        return RowShardSpec(tuple(names)[:1] or ("data",)), ""
    n = axes_size(mesh, axes)
    if rows % n != 0 or rows // n < 8:
        return None, (f"rows={rows} do not divide into >=8-row blocks "
                      f"over the {n}-device mesh axes {axes}")
    return RowShardSpec(axes), ""


ATTN_KINDS = ("attn", "attn_local")


def _has_attention(cfg) -> bool:
    return bool(cfg.is_encdec or cfg.shared_attn_every
                or any(k in ATTN_KINDS for k in cfg.layer_kinds()))


def seq_attention(cfg, mesh) -> bool:
    """Whether ``cfg``'s attention over ``mesh``'s model axis takes the
    sequence arm: the rules' "attn_q" pins the sequence (q heads that do
    not divide the axis), so each rank attends its rows of the sequence
    against the whole sequence's keys (``models/attention.py``)."""
    return _has_attention(cfg) and \
        _pinned_to_sequence(_head_rules(cfg, mesh)["attn_q"])


def _pinned_to_sequence(rule) -> bool:
    """Whether an "attn_q"/"attn_kv" entry pins the sequence dim to the
    model axis (heads that do not divide it) rather than the heads."""
    return _mentions(rule, "model", 1)


def _head_rules(cfg, mesh) -> dict:
    """The rules' head entries for ``cfg`` over ``mesh`` (the batch does
    not enter them)."""
    if "model" not in mesh_shape(mesh):
        mesh = {**mesh_shape(mesh), "model": 1}
    return activation_rules(mesh, batch_size=1, cfg=cfg)


def _recurrent_widths(cfg, tp: int) -> Dict[str, int]:
    """The widths each rank of the ``tp``-way model axis must hold whole
    parts of: mamba2's heads, its B and C width (groups x state) and
    d_inner; the xLSTM blocks' heads (where the head-split arm does not
    take them: ``head_split``), their widths (d_inner, d_model: a rank's
    share of a head's features) and the sLSTM's feed-forward width.  The
    encoder's frames are padded to a multiple of the axis
    (``models/encdec.py``), so they need not divide it."""
    kinds = set(cfg.layer_kinds())
    out = {}
    if "mamba2" in kinds:
        out["mamba2 heads"] = cfg.ssm_heads
        out["mamba2 groups x state (B and C)"] = cfg.ssm_groups * cfg.ssm_state
        out["mamba2 d_inner"] = cfg.ssm_heads * cfg.ssm_head_dim
    if kinds & {"mlstm", "slstm"}:
        if not _splits_heads(cfg.n_heads, tp):
            out["mLSTM/sLSTM heads"] = cfg.n_heads
        if "mlstm" in kinds:
            out["mLSTM d_inner"] = cfg.lstm_expand * cfg.d_model
        if "slstm" in kinds:
            out["sLSTM d_model"] = cfg.d_model
    if "slstm" in kinds:
        from repro_torch.models.xlstm import slstm_d_ff
        out["sLSTM d_ff"] = slstm_d_ff(cfg.d_model)
    return out


def _splits_heads(n_heads: int, tp: int) -> bool:
    """Whether the head-split arm takes ``n_heads`` over ``tp`` ranks: the
    axis is a multiple of the heads, and wider."""
    return tp % n_heads == 0 and n_heads % tp != 0


def head_split(cfg, mesh) -> int:
    """The ranks of the model axis each xLSTM head is split over, g = tp /
    H, where the axis is wider than the heads and a multiple of them (the
    head-split arm: rank r works on head r // g and owns the g-th part
    r % g of its features); 0 where the arm does not apply (no xLSTM
    block, or the heads divide the axis)."""
    tp = mesh_shape(mesh).get("model", 1)
    if not set(cfg.layer_kinds()) & {"mlstm", "slstm"} or \
            not _splits_heads(cfg.n_heads, tp):
        return 0
    return tp // cfg.n_heads


def tp_refusal(cfg, mesh) -> str:
    """Why the port cannot lay ``cfg`` out tensor- and sequence-parallel
    over ``mesh``'s model axis; "" where it can: d_ff divides the axis,
    and so does each recurrent width of ``_recurrent_widths`` (the xLSTM
    heads may instead be split over groups of ranks, ``head_split``).  The
    attention's q heads need not divide it: where ``activation_rules``'
    "attn_q" pins the sequence the attention takes the sequence arm
    (``seq_attention``), the encoder-decoder's included."""
    tp = mesh_shape(mesh).get("model", 1)
    widths = {"d_ff": cfg.d_ff} if cfg.d_ff else {}
    widths.update(_recurrent_widths(cfg, tp))
    for what, n in widths.items():
        if n % tp:
            extra = (f", nor is the axis a multiple of them (the head-split "
                     f"arm)") if what == "mLSTM/sLSTM heads" else ""
            return (f"{cfg.name}: {what} {n} does not divide the {tp}-way "
                    f"model axis{extra}, and no arm of the layout holds a "
                    "part of one")
    return ""


# the attention's kv leaves: a decoder-only block's, and the
# encoder-decoder's encoder, decoder self and cross attention
_KV = re.compile(r"(^|\.|_)attn\.(wk|wv)\.[wb]$")
_EXPERT_LEAF = re.compile(r"(^|\.)moe\.w_(gate|up|down)$")


def tp_holds(cfg, mesh, shapes: Optional[Dict[str, tuple]] = None
             ) -> Dict[str, bool]:
    """For each leaf whose plan puts "model" on a dim: whether the port
    holds that entry (True: each model rank keeps its 1/tp of the leaf, as
    ``tp_splits`` says) or holds the leaf whole over the model axis
    (False).  Held where the split falls on whole heads (q always, once
    ``tp_refusal`` passes; k and v where the rules' "attn_kv" keeps the kv
    heads local; mamba2's and the xLSTM blocks' heads, or under the
    head-split arm a g-th of one head's features), on whole d_ff
    columns, on whole vocab rows (the plan has already dropped an odd
    vocab's axis), and on the experts (slice 6a).  Where "attn_kv" pins
    the sequence instead, wk and wv are held whole and each rank keeps the
    kv heads its q heads read (``models/attention.py``).  Where "attn_q"
    pins the sequence (the sequence arm), wq's columns and wo's rows are
    held as the plan splits them, off head boundaries: the train step
    gathers them at use, decode computes on its columns.  A config
    ``tp_refusal`` refuses holds only its experts."""
    if shapes is None:
        from repro_torch.models.model import param_shapes
        shapes = param_shapes(cfg)
    plan = param_shardings(cfg, mesh, shapes)
    ok = not tp_refusal(cfg, mesh)
    kv_local = not _pinned_to_sequence(_head_rules(cfg, mesh)["attn_kv"])
    out = {}
    for path, spec in plan.items():
        if not any("model" in entry_axes(a) for a in spec):
            continue
        if _EXPERT_LEAF.search(path):
            out[path] = True
        elif _KV.search(path):
            out[path] = ok and kv_local
        else:
            out[path] = ok
    return out


class TPSplit(NamedTuple):
    """How the port splits a leaf it holds over "model" (``tp_splits``):
    ``kind`` "contiguous" (rank r holds the r-th 1/tp of dim ``dim``, the
    plan's split), "blocked" (dim ``dim`` is ``parts`` laid end to end,
    each split tp ways: rank r holds the r-th 1/tp of every part, in part
    order), "moved" (the plan splits dim ``plan_dim``; the port splits
    ``dim`` instead) or "grouped" (as "moved", but the dim, the heads, is
    cut into tp / ``g`` parts, each held whole on ``g`` consecutive ranks:
    the head-split arm's head block)."""
    kind: str
    dim: int
    parts: Tuple[int, ...] = ()
    plan_dim: Optional[int] = None
    g: int = 0


_IN_PROJ = re.compile(r"(^|\.)mamba\.in_proj\.w$")
_CONV = re.compile(r"(^|\.)mamba\.conv_[wb]$")
_SLSTM_R = re.compile(r"(^|\.)slstm\.r$")


def tp_splits(cfg, mesh, shapes: Optional[Dict[str, tuple]] = None
              ) -> Dict[str, TPSplit]:
    """For each leaf ``tp_holds`` holds: how.  The plan's contiguous split
    everywhere but in two places, where it does not fall on whole heads
    (ROADMAP queue 3, stated differences in layout):

    * mamba2's ``in_proj.w`` columns are its z | x | B | C | dt parts and
      its ``conv_w``/``conv_b`` channels the x | B | C parts: each part is
      split on its own ("blocked"), so rank r holds its heads' z, x and dt
      and 1/tp of B and C (``models/ssm.py`` gathers B and C whole);
    * the sLSTM's ``r`` (H, hd, 4 hd) is split over its heads (dim 0)
      rather than the plan's gate dim (dim 2), which would put one head's
      gates on different ranks ("moved"); under the head-split arm each
      head's block is held whole on its g ranks ("grouped"), so the
      recurrence issues no collective either."""
    if shapes is None:
        from repro_torch.models.model import param_shapes
        shapes = param_shapes(cfg)
    plan = param_shardings(cfg, mesh, shapes)
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    g = head_split(cfg, mesh)
    out = {}
    for path, held in tp_holds(cfg, mesh, shapes).items():
        if not held:
            continue
        dim = next(i for i, a in enumerate(plan[path])
                   if "model" in entry_axes(a))
        if _IN_PROJ.search(path):
            out[path] = TPSplit("blocked", dim,
                                (d_inner, d_inner, gn, gn, cfg.ssm_heads))
        elif _CONV.search(path):
            out[path] = TPSplit("blocked", dim, (d_inner, gn, gn))
        elif _SLSTM_R.search(path) and g:
            out[path] = TPSplit("grouped", 0, plan_dim=dim, g=g)
        elif _SLSTM_R.search(path):
            out[path] = TPSplit("moved", 0, plan_dim=dim)
        else:
            out[path] = TPSplit("contiguous", dim)
    return out
