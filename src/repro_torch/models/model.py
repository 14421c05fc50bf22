"""Config-driven backbone assembly for the training and serving paths.

Counterpart of ``repro/models/model.py`` for every one of the ten configs:
stacks of ``attn`` and ``attn_local`` blocks with a gated MLP or a
Mixture-of-Experts layer (yi-6b, stablelm-1.6b, qwen2-72b, minicpm-2b,
granite-moe-1b-a400m, llama4-scout-17b-a16e; qwen2-vl-72b, whose training
forward takes M-RoPE positions), the recurrent kinds ``mamba2``
(``models/ssm.py``; followed by the FFN half in a model without zamba2's
shared block, as granite-4.0-h-small's), ``mlstm`` and ``slstm``
(``models/xlstm.py``),
zamba2's shared attention block applied after every
``shared_attn_every``-th layer (one set of weights, a KV cache for each
application), and the encoder-decoder (``models/encdec.py``, where
``cfg.is_encdec``):

  init_params(cfg, seed, device, dtype)        -> params (nested dicts)
  forward(cfg, params, batch)                  -> {"logits", "value", ...}
  init_cache(cfg, batch, cache_len, ..., paged) -> cache
  decode_step(cfg, params, cache, batch, pos)  -> ({"logits", "value"}, cache)
  prefill_step(cfg, params, cache, batch, pos0, true_len)
  verify_step(cfg, params, cache, batch, pos, shift) -> ({"logits"}, pendings)
  commit_step(cfg, cache, pendings, pos, n_acc)       -> cache

Layers are a Python list walked in a loop (the JAX package stacks them for
``lax.scan``; ``repro_torch.bridge`` unstacks its parameters).  ``forward``
takes the f32 masters and casts each block's matrices inside the step, as
the JAX loss does, so gradients reach the f32 leaves.  For serving,
parameters are cast to the compute dtype ONCE (``cast_params``) by whoever
builds them: the JAX steps cast inside every call, which in eager PyTorch
would copy every weight each step.  Chunked prefill takes attention and
mamba2 layers (``supports_chunked_prefill``); speculative verify needs
attention-only caches; the other recurrent models and the
encoder-decoder prefill token by token, as in the reference.

Granite's multipliers (``ModelConfig``): the embedding's rows times
``embedding_multiplier``, each block's two branches times
``residual_multiplier`` before they join the residual, the softmax scale
``attention_multiplier`` (``attention._scale_q``) and the logits divided
by ``logits_scaling``; each is skipped where it is 1, so the other
configs run what they ran.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.distributed import collectives, ctx, fsdp
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import encdec
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_ep
from repro_torch.models import ssm
from repro_torch.models import xlstm
from repro_torch.models.config import ModelConfig

Params = Any
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN_KINDS = ("attn", "attn_local")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Flat {"layers.3.attn.wq.w": leaf, ...}, in ``tree_map`` order."""
    out: Dict[str, Any] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def tree_map(fn, tree, *rest):
    """fn on every leaf of nested dicts, lists and tuples (tuples come back
    as lists, the port's layer layout); with ``rest``, fn(leaf, *leaves at
    the same place in each of the other trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)



def _ffn_shapes(cfg: ModelConfig) -> dict:
    """The FFN half's layout: ln2, then the experts (and a shared expert
    where the config has one) or the gated MLP."""
    d = cfg.d_model
    half = {"ln2": cm.norm_shapes(cfg.norm, d)}
    if cfg.n_experts:
        half["moe"] = moe_mod.moe_shapes(d, cfg.d_ff_expert, cfg.n_experts,
                                         cfg.experts_held)
        if cfg.d_ff_shared:
            half["shared"] = mlp_mod.gated_mlp_shapes(d, cfg.d_ff_shared)
    elif cfg.d_ff:
        half["mlp"] = mlp_mod.gated_mlp_shapes(d, cfg.d_ff)
    return half


def _block_shapes(cfg: ModelConfig, kind: str) -> dict:
    """One block's layout, ``_init_block``'s."""
    d = cfg.d_model
    norm = cm.norm_shapes(cfg.norm, d)
    if kind in ATTN_KINDS:
        return {"ln1": norm,
                "attn": attn.attention_shapes(d, cfg.n_heads, cfg.n_kv_heads,
                                              cfg.hd, qkv_bias=cfg.qkv_bias),
                **_ffn_shapes(cfg)}
    if kind == "mamba2":
        layer = {"ln1": norm, "mamba": ssm.mamba2_shapes(
            d, d_state=cfg.ssm_state, n_heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
            conv_width=cfg.ssm_conv_width)}
        return {**layer, **_ffn_shapes(cfg)} if cfg.has_ffn(kind) else layer
    if kind == "mlstm":
        return {"ln1": norm, "mlstm": xlstm.mlstm_shapes(
            d, n_heads=cfg.n_heads, expand=cfg.lstm_expand,
            conv_width=cfg.ssm_conv_width)}
    if kind == "slstm":
        return {"ln1": norm,
                "slstm": xlstm.slstm_shapes(d, n_heads=cfg.n_heads)}
    raise ValueError(f"unknown block kind {kind}")


def _shape_tree(cfg: ModelConfig) -> dict:
    """Nested dicts of shape tuples, the layout of ``init_params``."""
    if cfg.is_encdec:
        return encdec.shape_tree(cfg)
    d = cfg.d_model
    tree = {"embed": {"table": (cfg.vocab_size, d)},
            "final_norm": cm.norm_shapes(cfg.norm, d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (d, cfg.vocab_size)}
    if cfg.value_head:
        tree["value_head"] = {"w": (d, 1)}
    if cfg.shared_attn_every:
        tree["shared_attn"] = _block_shapes(cfg, "attn")
    by_kind = {k: _block_shapes(cfg, k) for k in set(cfg.layer_kinds())}
    # shared, never mutated
    tree["layers"] = [by_kind[k] for k in cfg.layer_kinds()]
    return tree


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat {"layers.3.attn.wq.w": shape, ...} of every parameter."""
    return flatten(_shape_tree(cfg))


def _block_keys(cfg: ModelConfig, kind: str, key: torch.Tensor,
                prefix: str, out: dict, split) -> None:
    """The keys of one block's random leaves, ``_init_block``'s tree: the
    block key split in four, the first for the attention (then four: wq,
    wk, wv, wo) or the recurrent layer, the second for the gated MLP
    (three: gate, up, down) or the experts (``init_moe``'s four), the
    third for a shared expert (three); a mamba2 block with the FFN half
    takes the second and third as an attention block does.  mamba2
    splits its key in four (in_proj, conv_w, dt_bias's uniform draw,
    out_proj); mLSTM in eight (up_x, up_z, conv_w, wq, wk, wv, w_i, w_f)
    and its ``down`` takes fold_in(key, 99); sLSTM in seven (w_in, r,
    ff_gate, ff_up, ff_down)."""
    ks = split(key, 4)

    def put(sub, names, keys):
        for name, k in zip(names, keys):
            out[f"{prefix}.{sub}.{name}"] = k
    if cfg.has_ffn(kind):
        if cfg.n_experts:
            put("moe", moe_mod.LEAVES, split(ks[1], 4))
            if cfg.d_ff_shared:
                put("shared", ("gate.w", "up.w", "down.w"), split(ks[2], 3))
        elif cfg.d_ff:
            put("mlp", ("gate.w", "up.w", "down.w"), split(ks[1], 3))
    if kind in ATTN_KINDS:
        put("attn", ("wq.w", "wk.w", "wv.w", "wo.w"), split(ks[0], 4))
    elif kind == "mamba2":
        put("mamba", ("in_proj.w", "conv_w", "dt_bias", "out_proj.w"),
            split(ks[0], 4))
    elif kind == "mlstm":
        put("mlstm", ("up_x.w", "up_z.w", "conv_w", "wq.w", "wk.w", "wv.w",
                      "w_i.w", "w_f.w"), split(ks[0], 8))
        out[f"{prefix}.mlstm.down.w"] = prng.fold_in(ks[0], 99)
    elif kind == "slstm":
        put("slstm", ("w_in.w", "r", "ff_gate.w", "ff_up.w", "ff_down.w"),
            split(ks[0], 7))


def _leaf_keys(cfg: ModelConfig, seed: int, partitionable: bool) -> dict:
    """{path: key} of every random leaf, the key tree of
    ``repro/models/model.py::init_params``: split(key(seed), n_layers + 5),
    the last four keys for the embedding, the LM head, the value head and
    zamba2's shared block, key i for layer i (``_block_keys``); an
    encoder-decoder's own tree (``encdec.leaf_keys``).  On the CPU: a few
    hundred tiny hashes."""
    def split(k, n):
        return prng.split(k, n, partitionable=partitionable)
    if cfg.is_encdec:
        return encdec.leaf_keys(cfg, prng.key(seed), split)
    keys = split(prng.key(seed), cfg.n_layers + 5)
    out = {"embed.table": keys[-1], "lm_head.w": keys[-2],
           "value_head.w": keys[-3]}
    if cfg.shared_attn_every:
        _block_keys(cfg, "attn", keys[-4], "shared_attn", out, split)
    for i, kind in enumerate(cfg.layer_kinds()):
        _block_keys(cfg, kind, keys[i], f"layers.{i}", out, split)
    return out


def _init_std(cfg: ModelConfig, path: str, shape: tuple) -> float:
    """Spread of a random matrix: embeddings 0.02, the experts'
    ``init_moe`` spreads (router 0.02, w_gate and w_up 1/sqrt(d_model),
    w_down 1/sqrt(d_ff_expert)), the recurrent layers' conv weights 0.2,
    sLSTM's recurrent ``r`` (H, hd, 4 hd) 1/sqrt(hd), linears
    1/sqrt(d_in)."""
    parts = path.split(".")
    if parts[-1] == "table":
        return 0.02
    if len(parts) >= 2 and parts[-2] == "moe":
        return moe_mod.init_std(parts[-1], cfg.d_model, cfg.d_ff_expert)
    if parts[-1] == "conv_w":
        return 0.2
    if parts[-1] == "r":
        return 1.0 / shape[1] ** 0.5
    return cm.linear_std(shape[0])


def _init_vector(name: str, shape: tuple, key, dev,
                 partitionable: bool) -> torch.Tensor:
    """A 1-D leaf: mamba2's A_log = log(linspace(1, 16, H)) and its
    dt_bias, the inverse softplus of exp(uniform(log 1e-3, log 1e-1))
    drawn from its key; D and norm scales one; biases zero."""
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                        dtype=torch.float32, device=dev))
    if name == "dt_bias":
        lo, hi = (float(torch.log(torch.tensor(v, dtype=torch.float32)))
                  for v in (1e-3, 1e-1))
        u = prng.uniform(key.to(dev), shape, lo, hi,
                         partitionable=partitionable)
        return torch.log(torch.expm1(torch.exp(u)))
    fill = 1.0 if name in ("scale", "D") else 0.0
    return torch.full(shape, fill, dtype=torch.float32, device=dev)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, *,
                partitionable: bool = True) -> Params:
    """The JAX package's ``init_params(cfg, jax.random.key(seed))``, layers
    unstacked: a normal truncated at +-2 times each matrix's spread
    (``_init_std``), drawn by ``prng`` from the reference's key tree
    (``partitionable``: the threefry counter layout, see ``prng``);
    vectors as ``_init_vector``.  Matrices are drawn in f32 and stored in
    ``dtype`` (pass the compute dtype to build serving weights directly
    on the card); 1-D parameters stay f32.  They agree with jax's within
    a few f32 ulps (``prng.truncated_normal``)."""
    dev = resolve(device)
    keys = _leaf_keys(cfg, seed, partitionable)
    flat = {}
    for path, shape in param_shapes(cfg).items():
        name = path.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            std = _init_std(cfg, path, shape)
            flat[path] = prng.truncated_normal(
                keys[path].to(dev), -2.0, 2.0, shape, scale=std,
                dtype=dtype, partitionable=partitionable)
        else:
            flat[path] = _init_vector(name, shape, keys.get(path), dev,
                                      partitionable)
    return unflatten(flat)


def unflatten(flat: Dict[str, Any]) -> Params:
    """Inverse of the flat-path layout: "layers.3.x" keys become list
    entries."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Matrices to the compute dtype; vectors (norm scales, biases) stay
    f32.  Run once when serving weights are built; ``forward`` runs it
    inside the step on the f32 masters."""
    dt = compute_dtype(cfg)
    return tree_map(lambda x: x.to(dt) if x.dim() >= 2 and
                     x.dtype == torch.float32 else x, params)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    return cfg.sliding_window if kind == "attn_local" else None


def _state_cache(cfg: ModelConfig, kind: str, batch: int, dev) -> dict:
    """A recurrent layer's state, f32 (the engine's cache dtype in the
    reference; a conv state holds inputs of the compute dtype, which f32
    keeps exactly)."""
    if kind == "mamba2":
        return ssm.init_mamba2_state(batch, cfg, torch.float32, dev)
    if kind == "mlstm":
        return xlstm.init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                      expand=cfg.lstm_expand,
                                      conv_width=cfg.ssm_conv_width,
                                      device=dev)
    if kind == "slstm":
        return xlstm.init_slstm_state(batch, cfg.d_model, cfg.n_heads, dev)
    raise ValueError(f"unknown block kind {kind}")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               paged: Optional[attn.PagedLayout] = None) -> dict:
    """One KV cache of ``dtype`` (f32, bf16, or int8 with f32 row scales;
    the JAX package's ``kv_dtype``) per attention layer, and a recurrent
    layer's f32 state (``_state_cache``).  Sliding-window layers keep a
    ring of min(cache_len, window) rows.  Zamba2's shared block adds
    ``"shared"``: n_layers // shared_attn_every contiguous KV caches, one
    an application.  Under the ``decode_cp`` rules a KV cache whose length
    divides over the ranks holds only this rank's slice of it
    (``attention.init_kv_cache``).  With ``paged`` every global (``attn``)
    layer takes the page-pool layout, all of them behind one page table,
    which the cache also holds as ``pt``; ring layers, recurrent layers
    and the shared block's caches stay as they are.  An encoder-decoder
    takes ``encdec.init_cache``."""
    dev = resolve(device)
    if cfg.is_encdec:
        return encdec.init_cache(cfg, batch, cache_len, dtype, dev)
    cache: Dict[str, Any] = {}
    if paged is not None and "attn" in cfg.layer_kinds():
        cache["pt"] = torch.full((batch, cache_len // paged.page_size), -1,
                                 dtype=torch.int32, device=dev)
    layers: List[dict] = []
    for kind in cfg.layer_kinds():
        if kind not in ATTN_KINDS:
            layers.append(_state_cache(cfg, kind, batch, dev))
            continue
        if kind == "attn" and "pt" in cache:
            layers.append(attn.init_paged_kv_cache(
                batch, cache_len, cfg.n_kv_heads, cfg.hd,
                page_size=paged.page_size, n_pages=paged.n_pages,
                dtype=dtype, device=dev, pt=cache["pt"]))
            continue
        clen = cache_len
        if kind == "attn_local":
            clen = min(cache_len, cfg.sliding_window or cache_len)
        layers.append(attn.init_kv_cache(batch, clen, cfg.n_kv_heads,
                                         cfg.hd, dtype, dev))
    cache["layers"] = layers
    if cfg.shared_attn_every:
        cache["shared"] = [
            attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.hd,
                               dtype, dev)
            for _ in range(cfg.n_layers // cfg.shared_attn_every)]
    return cache


def state_leaves(layer: dict) -> List[str]:
    """A layer cache's per-slot leaves (batch dimension 0): a contiguous
    KV cache's k, v (and int8 scales), or every tensor of a recurrent
    state; none for a paged layer (its pools have no batch dimension)."""
    if "kp" in layer:
        return []
    if "k" in layer:
        return attn.kv_leaves(layer)
    return [n for n, t in layer.items() if torch.is_tensor(t)]


def slot_layers(cache: dict) -> List[dict]:
    """Every layer cache of a model cache that holds per-slot rows, in a
    fixed order: the layers, then zamba2's shared caches (an
    encoder-decoder's self and cross caches)."""
    if "self" in cache:
        return cache["self"] + cache["cross"]
    return cache["layers"] + cache.get("shared", [])


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill block-writes KV caches and runs mamba2 layers by
    the chunked scan from each row's carried state
    (``ssm.mamba2_prefill``); xLSTM's states, zamba2's shared block and the
    encoder-decoder prefill token by token (the engine's
    ``_prefill_loop``), as in the reference."""
    return (not cfg.is_encdec
            and not cfg.shared_attn_every
            and all(k in ATTN_KINDS or k == "mamba2"
                    for k in cfg.layer_kinds()))


def supports_verify(cfg: ModelConfig) -> bool:
    """Speculative verify scores a chunk without writing: attention-only
    caches."""
    return supports_chunked_prefill(cfg) and all(
        k in ATTN_KINDS for k in cfg.layer_kinds())


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    """x times a config multiplier, untouched where it is 1."""
    return x if m == 1.0 else x * m


def _embed_inputs(cfg: ModelConfig, params: Params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = cm.embed(params["embed"], batch["tokens"])
    return _scaled(x.to(compute_dtype(cfg)), cfg.embedding_multiplier)


def _moe_rule(s: int) -> Optional[dict]:
    """The installed ``moe_ep`` rule where the sequence of ``s`` divides
    over its model ranks, else None: the reference's rule for taking the
    expert-parallel MoE (``repro/models/model.py:91-104``)."""
    ep = (ctx.current_rules() or {}).get("moe_ep")
    return ep if ep is not None and s % ep["tp"] == 0 else None


def _count_moe(counts: torch.Tensor, kept: torch.Tensor) -> None:
    """The ``model.moe`` span's counts of a dropless block: the held
    assignments, the busiest held expert's rows, the held experts hit and
    the assignments dropped (none: there is no capacity).  One host sync,
    made only while a profiler records."""
    n, top, hit = torch.stack([kept.to(counts.dtype), counts.max(),
                               (counts > 0).sum()]).tolist()
    spans.count(assignments=n, rows_max=top, experts_hit=hit, dropped=0)


def _ffn_half(cfg: ModelConfig, p: Params, x: torch.Tensor,
              ep: Optional[dict] = None, tp: Optional[fsdp.TPRule] = None):
    """The block's second residual half: (x + FFN(norm(x)), the experts'
    load-balance loss or None).  The FFN is the experts where the config
    has them (dropless, ``moe.moe_apply_dropless``, where its capacity
    factor is 0; plus the shared expert where it has one), the gated MLP
    otherwise.  The capacity-routed experts are expert-parallel
    (``moe_ep.moe_apply_ep``) under the ``moe_ep`` rule ``ep``
    (``_moe_rule``, or the layout's ``fsdp.ep_rule`` under tensor
    parallelism), dense otherwise (``moe.moe_apply``: its capacity is
    per call, every row of the call, padding and idle slots included,
    competing for it, as in the JAX steps); the route is counted
    (``dispatch.route_counts``).  Under tensor parallelism (``tp``) x is
    this rank's sequence rows: the experts route them as they are, the
    gated MLP runs on its d_ff columns over the gathered sequence and its
    partial sums are reduce-scattered back to the rows."""
    y = cm.norm_rows(cfg.norm, p["ln2"], x, tp, rms_eps=cfg.rms_norm_eps)
    if cfg.n_experts:
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                  act=cfg.act)
        with spans.span("model.moe") as live:
            if not cfg.capacity_routed:
                dispatch.count_route("moe_dropless")
                out, lb = moe_mod.moe_apply_dropless(
                    p["moe"], y, top_k=cfg.top_k, act=cfg.act,
                    on_counts=_count_moe if live else None)
            elif ep is not None:
                dispatch.count_route("moe_ep")
                out, lb = moe_ep.moe_apply_ep(p["moe"], y, rule=ep,
                                              sp=tp is not None, **kw)
            else:
                dispatch.count_route("moe_dense")
                out, lb = moe_mod.moe_apply(p["moe"], y, **kw)
            if "shared" in p:
                out = out + mlp_mod.gated_mlp(p["shared"], y, act=cfg.act)
        return x + _scaled(out, cfg.residual_multiplier), lb
    if tp is None:
        return x + mlp_mod.gated_mlp(p["mlp"], y, act=cfg.act), None
    y = collectives.gather_sum(y, tp.group, 1)
    y = mlp_mod.gated_mlp(p["mlp"], y, act=cfg.act)
    return x + collectives.scatter_sum(y, tp.group, 1), None


def _rope_tables(cfg: ModelConfig, batch: Dict[str, torch.Tensor], s: int,
                device) -> tuple:
    """(cos, sin) of the training forward, as the JAX ``_rope_tables``:
    M-RoPE from batch["positions"] (3, B, S) where the config has
    sections (``arange(S)`` on all three axes without them), plain RoPE
    at 0 .. S-1 otherwise; (None, None) under NoPE."""
    if not cfg.rope:
        return None, None
    if cfg.mrope_sections is not None:
        pos = batch.get("positions")
        if pos is None:
            b = batch.get("tokens", batch.get("embeds")).shape[0]
            pos = torch.arange(s, device=device)[None, None].expand(3, b, s)
        return cm.mrope_cos_sin(pos.to(device), cfg.hd, cfg.rope_theta,
                                cfg.mrope_sections)
    return cm.rope_cos_sin(torch.arange(s, device=device)[None], cfg.hd,
                           cfg.rope_theta)


def _heads(cfg: ModelConfig, params: Params, x: torch.Tensor,
           tp: Optional[fsdp.TPRule] = None) -> dict:
    """The final norm, the LM head (the tied table where the config ties
    them) and the value head.  Under tensor parallelism x is this rank's
    sequence rows: the value head runs on them (its leaf's gradient summed
    over the model group) and its values are all-gathered, so every model
    rank holds all of them; the normed rows are all-gathered for the LM
    head.  With the vocab split (``tp.vocab``) the logits are this rank's
    V / tp columns (``out["vocab_start"]`` their first) and the gather's
    backward sums the ranks' partial cotangents; with the vocab whole each
    rank computes every logit, whose cotangents are alike on the ranks, so
    the backward keeps this rank's rows."""
    x = cm.norm_rows(cfg.norm, params["final_norm"], x, tp,
                     rms_eps=cfg.rms_norm_eps)
    out = {}
    if cfg.value_head:
        vh = params["value_head"]
        if tp is not None:
            vh = {k: collectives.sum_grads(t, tp.group)
                  for k, t in vh.items()}
        value = cm.linear(vh, x)[..., 0].float()
        if tp is not None:
            value = collectives.gather_slice(value, tp.group, 1)
        out["value"] = value
    if tp is not None:
        gather = collectives.gather_sum if tp.vocab else \
            collectives.gather_slice
        x = gather(x, tp.group, 1)
    if cfg.tie_embeddings:
        table = params["embed"]["table"]
        out["logits"] = x @ table.T.to(x.dtype)
    else:
        out["logits"] = cm.linear(params["lm_head"], x, dtype=x.dtype)
    out["logits"] = _scaled(out["logits"], 1.0 / cfg.logits_scaling)
    if tp is not None and tp.vocab:
        out["vocab_start"] = tp.rank * out["logits"].shape[-1]
    return out


def _ssm_span(kind: str):
    """The ``model.ssm`` span around a Mamba-2 mixer call (none around the
    other recurrent kinds)."""
    return spans.span("model.ssm") if kind == "mamba2" else \
        contextlib.nullcontext()


_TRAIN = {"mamba2": ("mamba", ssm.mamba2_train),
          "mlstm": ("mlstm", xlstm.mlstm_train),
          "slstm": ("slstm", xlstm.slstm_train)}
_DECODE = {"mamba2": ("mamba", ssm.mamba2_decode),
           "mlstm": ("mlstm", xlstm.mlstm_decode),
           "slstm": ("slstm", xlstm.slstm_decode)}


def _block_train(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 aux: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 layout: Optional[fsdp.Layout] = None, prefix: str = "",
                 ep: Optional[dict] = None,
                 tp: Optional[fsdp.TPRule] = None):
    """One residual block over the full sequence -> (x, aux plus the
    block's load-balance loss).  ``p`` holds the f32 masters (this rank's
    shards under ``layout``, whose paths start with ``prefix``); the cast
    to the compute dtype, and the gather of the cast shards, happen here,
    so under ``cfg.remat`` they are recomputed in the backward and only
    one block's cast, whole copies are alive at a time.  ``ep``: the
    ``moe_ep`` rule the forward found, and ``tp``: the tensor-parallel
    rule, arguments rather than read from the thread-local rules because
    the recomputation runs on the autograd engine's thread (a card's
    backward runs on a device thread of its own).  The recomputation
    routes the tokens as the forward did: top-k is a stable sort.

    Under ``tp`` (Megatron-SP) x is this rank's rows of the sequence: the
    norm runs on them, they are all-gathered before the attention's (and
    the MLP's) column-parallel products, or a recurrent block's, and the
    row-parallel products' partial sums are reduce-scattered back to the
    rows.  A recurrent block runs on this rank's heads (``models/ssm.py``,
    ``models/xlstm.py``).  Under the sequence arm (``tp.seq``) the
    attention runs on the rows themselves, with no gather before it or
    scatter after it: its model-held leaves are gathered whole here
    (``fsdp.gather_leaf(model="sum")``) and it gathers k and v along the
    sequence (``attention._attend_seq``)."""
    p = cast_params(cfg, p)
    seq = tp is not None and tp.seq
    if layout is not None:
        p = fsdp.gather(layout, prefix, p,
                        model="slice" if ep is None and tp is None else None,
                        model_sum=("attn",) if seq else ())
    h = cm.norm_rows(cfg.norm, p["ln1"], x, tp, rms_eps=cfg.rms_norm_eps)
    if kind in _TRAIN:
        name, fn = _TRAIN[kind]
        h = cm.on_sequence(lambda seq: fn(p[name], seq, cfg, tp), h, tp)
    else:
        if tp is not None and not seq:
            h = collectives.gather_sum(h, tp.group, 1)
        h = attn.attend_train(p["attn"], h, cos, sin, cfg,
                              window=_window(cfg, kind), tp=tp)
        if tp is not None and not seq:
            h = collectives.scatter_sum(h, tp.group, 1)
    x = x + _scaled(h, cfg.residual_multiplier)
    if not cfg.has_ffn(kind):
        return x, aux
    x, lb = _ffn_half(cfg, p, x, ep, tp)
    return x, (aux if lb is None else aux + lb)


def _sp_inputs(cfg: ModelConfig, top: Params, batch: Dict[str, torch.Tensor],
               tp: fsdp.TPRule) -> torch.Tensor:
    """The embedded inputs as this rank's rows of the sequence: the
    vocab-parallel embedding where the table is split over the vocab,
    else this rank's slice of the whole lookup (its backward gathers the
    rows' cotangents, so each rank's table gradient covers every token)."""
    s = batch.get("tokens", batch.get("embeds")).shape[1]
    if s % tp.size:
        raise ValueError(f"sequence {s} does not divide over the {tp.size} "
                         "model ranks of the sequence-parallel residual")
    if tp.vocab and "embeds" not in batch:
        table = top["embed"]["table"]
        return _scaled(cm.embed_vocab_parallel(
            top["embed"], batch["tokens"], start=tp.rank * table.shape[0],
            group=tp.group, dtype=compute_dtype(cfg)),
            cfg.embedding_multiplier)
    return collectives.scatter_slice(_embed_inputs(cfg, top, batch),
                                     tp.group, 1)


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor],
            layout: Optional[fsdp.Layout] = None) -> Dict[str, torch.Tensor]:
    """Training (full-sequence) forward.  batch {"tokens": (B, S)} (or
    {"embeds": (B, S, d)}), with {"positions": (3, B, S)} for M-RoPE and
    {"enc_frames": (B, F, d)} for the encoder-decoder; ``params`` the f32
    masters, or this rank's shards of them under ``layout``
    (``distributed/fsdp.py``), which the forward gathers: the top-level
    leaves once, each block's inside the block.  Returns {"logits"
    (B, S, V) in the compute dtype, "value" (B, S) f32, "aux_loss" () f32:
    the experts' load-balance losses summed over the layers, 0 without
    experts}.  Zamba2's shared block runs after every
    ``shared_attn_every``-th layer.  With ``cfg.remat`` each block, the
    shared block's applications included, runs under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``):
    its activations are recomputed in the backward.  The encoder-decoder
    (``encdec.forward``, which gathers a layer at a time) has no remat,
    as in the reference.

    Under a tensor-parallel layout (``fsdp.tp_rule``) the residual stream
    between blocks is this rank's S / tp rows of the sequence, the rotary
    tables are whole (attention runs on the gathered sequence, or, under
    the sequence arm, slices them to the rank's rows), zamba2's
    shared block takes the attention blocks' path (its applications'
    gradients add up on its one set of shards), the
    experts are expert-parallel under the layout's rule (``fsdp.ep_rule``;
    the installed rules are not read), and the logits are this rank's
    vocab columns where the vocab is split (``_heads``)."""
    if cfg.is_encdec:
        return encdec.forward(cfg, params, batch, layout)
    tp = fsdp.tp_rule(layout)
    top = fsdp.gather(layout, "", {k: v for k, v in params.items()
                                   if k not in ("layers", "shared_attn")})
    # gather, then cast: the values of casting the table first
    if tp is None:
        x = _embed_inputs(cfg, top, batch)
        s = x.shape[1]
    else:
        x = _sp_inputs(cfg, top, batch, tp)
        s = x.shape[1] * tp.size
    cos, sin = _rope_tables(cfg, batch, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not cfg.n_experts:
        ep = None
    elif tp is not None:
        ep = fsdp.ep_rule(layout)
    else:
        ep = _moe_rule(s)

    def block(kind, p, x, aux, prefix):
        args = (cfg, kind, p, x, aux, cos, sin, layout, prefix, ep, tp)
        if cfg.remat:
            return checkpoint(_block_train, *args, use_reentrant=False)
        return _block_train(*args)
    for i, (kind, p) in enumerate(zip(cfg.layer_kinds(), params["layers"])):
        x, aux = block(kind, p, x, aux, f"layers.{i}")
        if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
            x, aux = block("attn", params["shared_attn"], x, aux,
                           "shared_attn")
    out = _heads(cfg, cast_params(cfg, top), x, tp)
    out["aux_loss"] = aux
    return out


def _ffn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                tp: Optional[fsdp.TPRule]) -> torch.Tensor:
    """The block's second half at decode.  Under the serving layout the
    gated MLP runs on this rank's d_ff columns and the experts on this
    rank's E / tp, each routed over all E under the global capacity (the
    reference runs the dense block at decode: ``_moe_rule(1)`` is None);
    the partial sums are summed over the model group in f32
    (``collectives.sum_partials``)."""
    if tp is None:
        return _ffn_half(cfg, p, x)[0]
    y = cm.apply_norm(cfg.norm, p["ln2"], x, rms_eps=cfg.rms_norm_eps)
    if cfg.n_experts:
        dispatch.count_route("tp_experts_local")
        e_loc = p["moe"]["w_gate"].shape[0]
        y = moe_mod.moe_apply_local(
            p["moe"], y, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.act,
            first=tp.rank * e_loc)
    else:
        y = mlp_mod.gated_mlp(p["mlp"], y, act=cfg.act)
    return x + collectives.sum_partials(y, tp.group)


def _block_decode(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                  c: dict, pos: torch.Tensor, paged,
                  tp: Optional[fsdp.TPRule] = None) -> torch.Tensor:
    """One residual block of a decode step; writes the layer's cache or
    state in place.  Under the serving layout (``tp``) x is whole on every
    model rank (the one-token residual is replicated over "model": the
    Megatron-SP row split has one row to split), each half computes this
    rank's partial sum, and the halves are summed over the model group in
    f32 (``collectives.sum_partials``)."""
    h = cm.apply_norm(cfg.norm, p["ln1"], x, rms_eps=cfg.rms_norm_eps)
    if kind in _DECODE:
        name, fn = _DECODE[kind]
        with _ssm_span(kind) as live:
            if live:
                spans.count(rows=x.shape[0], positions=x.shape[0],
                            masked=0)
            h = fn(p[name], h, c, cfg, tp)[0]
    else:
        h, _ = attn.attend_decode(p["attn"], h, c, pos, cfg,
                                  window=_window(cfg, kind), paged=paged,
                                  tp=tp)
    if tp is not None:
        h = collectives.sum_partials(h, tp.group)
    x = x + _scaled(h, cfg.residual_multiplier)
    return _ffn_decode(cfg, p, x, tp) if cfg.has_ffn(kind) else x


def _decode_inputs(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor],
                   tp: Optional[fsdp.TPRule]) -> torch.Tensor:
    """The embedded one-token inputs, whole on every model rank: under
    the serving layout with the vocab split, each rank looks up the ids it
    owns and the rows are summed over the model group (the vocab-parallel
    embedding of ``_sp_inputs`` without its sequence split)."""
    if tp is None or not tp.vocab or "embeds" in batch:
        return _embed_inputs(cfg, params, batch)
    table = params["embed"]["table"]
    part = cm.vocab_rows(params["embed"], batch["tokens"],
                         start=tp.rank * table.shape[0])
    return _scaled(collectives.all_reduce(part.to(compute_dtype(cfg)),
                                          tp.group), cfg.embedding_multiplier)


def decode_heads(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 tp: Optional[fsdp.TPRule] = None) -> dict:
    """``_heads`` of a decode step.  Under the serving layout x is whole on
    every model rank: the value head runs on it as it is (the leaf is held
    whole), and with the vocab split the logits of this rank's columns are
    all-gathered over the model group, so every rank samples from the
    whole row and draws the same token."""
    out = _heads(cfg, params, x)
    if tp is not None and tp.vocab:
        out["logits"] = collectives.gather_slice(out["logits"], tp.group, 2)
    return out


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                batch: Dict[str, torch.Tensor], pos: torch.Tensor,
                layout: Optional[fsdp.Layout] = None):
    """One-token decode.  batch {"tokens": (B, 1)} (or {"embeds": (B, 1,
    d)}); pos the current absolute position, a lockstep scalar or per slot
    (B,) (the recurrent blocks ignore it).  ``params`` already cast
    (``cast_params``).  Writes the caches and states in place; returns
    (out, cache).

    Under the serving layout (``layout``, ``fsdp.serve_layout``; the
    caches laid out by ``sharding.cache_shardings`` under the installed
    ``decode_rules``) ``params`` are this rank's shards, the batch and the
    caches this rank's rows, and every block runs on this rank's heads,
    d_ff columns or experts with its partial sums summed over the model
    group; the logits come back whole on every rank."""
    tp = fsdp.tp_rule(layout)
    if cfg.is_encdec:
        return encdec.decode_step(cfg, params, cache, batch, pos, tp)
    x = _decode_inputs(cfg, params, batch, tp)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    paged = attn.model_paged_index(cache, pos=pos)
    shared = iter(cache.get("shared", ()))
    for i, (kind, p, c) in enumerate(zip(cfg.layer_kinds(), params["layers"],
                                         cache["layers"])):
        x = _block_decode(cfg, kind, p, x, c, pos, paged, tp)
        if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
            x = _block_decode(cfg, "attn", params["shared_attn"], x,
                              next(shared), pos, None, tp)
    return decode_heads(cfg, params, x, tp), cache


def prefill_step(cfg: ModelConfig, params: Params, cache: dict,
                 batch: Dict[str, torch.Tensor], pos0: int = 0,
                 true_len: Optional[torch.Tensor] = None):
    """Prefill one prompt chunk: batch {"tokens": (B, C)} covering absolute
    positions [pos0, pos0 + C).  Every attention layer writes its cache
    rows and runs one append-attention call.  Returns (out {"logits"
    (B, C, V), "value" (B, C)}, cache); callers gather each row's last
    prompt position (prompts are right-padded; ``true_len`` (B,) masks
    ring writes past each row's real length)."""
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"{cfg.name}: chunked prefill needs attention-only caches "
            "beside mamba2 states")
    x = _embed_inputs(cfg, params, batch)
    b, c = x.shape[:2]
    paged = attn.model_paged_index(cache, pos0=pos0, c=c, true_len=true_len)
    for kind, p, lc in zip(cfg.layer_kinds(), params["layers"],
                           cache["layers"]):
        h = cm.apply_norm(cfg.norm, p["ln1"], x, rms_eps=cfg.rms_norm_eps)
        if kind == "mamba2":
            with _ssm_span(kind) as live:
                if live:
                    real = b * c if true_len is None else int(
                        (true_len.to(x.device).long() - pos0).clamp(0, c)
                        .sum())
                    spans.count(rows=b, positions=b * c,
                                masked=b * c - real)
                h = ssm.mamba2_prefill(p["mamba"], h, lc, cfg, pos0,
                                       true_len)
        else:
            h, _ = attn.attend_prefill(p["attn"], h, lc, pos0, cfg,
                                       window=_window(cfg, kind),
                                       true_len=true_len, paged=paged)
        x = x + _scaled(h, cfg.residual_multiplier)
        if cfg.has_ffn(kind):
            x = _ffn_half(cfg, p, x)[0]
    return _heads(cfg, params, x), cache


def verify_step(cfg: ModelConfig, params: Params, cache: dict,
                batch: Dict[str, torch.Tensor], pos: torch.Tensor,
                shift: int):
    """Speculative verify: batch {"tokens": (B, K)}, row j's current token
    and drafts at positions pos[j] + i; pos (B,); ``shift`` a static bound
    on pos (the logical cache length).  ``params`` already cast.  Writes
    nothing: returns (out {"logits" (B, K, V)}, pendings), ``pendings``
    one dict of the chunk's K/V a layer, which ``commit_step`` writes for
    the accepted rows after the accept decision."""
    if not supports_verify(cfg):
        raise NotImplementedError(
            f"{cfg.name}: speculative verify needs attention-only caches")
    x = _embed_inputs(cfg, params, batch)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    paged = attn.model_paged_index(cache, pos=pos, c=x.shape[1], verify=True)
    pendings = []
    for kind, p, c in zip(cfg.layer_kinds(), params["layers"],
                          cache["layers"]):
        h, pend = attn.attend_verify(
            p["attn"], cm.apply_norm(cfg.norm, p["ln1"], x,
                                     rms_eps=cfg.rms_norm_eps),
            c, pos, cfg, shift=shift, window=_window(cfg, kind), paged=paged)
        pendings.append(pend)
        x = _ffn_half(cfg, p, x + _scaled(h, cfg.residual_multiplier))[0]
    out = _heads(cfg, params, x)
    return {"logits": out["logits"]}, pendings


def commit_step(cfg: ModelConfig, cache: dict, pendings, pos: torch.Tensor,
                n_acc: torch.Tensor) -> dict:
    """Commit the accepted prefix of a verify chunk: row j writes pending
    rows i < n_acc[j] at positions pos[j] + i into every layer's cache, in
    place (n_acc[j] == 0 writes nothing for that row)."""
    kq = pendings[0]["k"].shape[1]
    dev = pendings[0]["k"].device
    pos = torch.as_tensor(pos, device=dev).expand(n_acc.shape[0])
    paged = attn.model_paged_index(cache, pos=pos, c=kq, verify=True)
    for kind, c, pend in zip(cfg.layer_kinds(), cache["layers"], pendings):
        attn.commit_kv(c, pend, pos, n_acc.to(dev), window=_window(cfg, kind),
                       paged=paged)
    return cache
