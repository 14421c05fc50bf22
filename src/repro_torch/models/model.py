"""Config-driven backbone assembly for the training and serving paths.

Counterpart of ``repro/models/model.py`` for decoder stacks of ``attn`` and
``attn_local`` blocks with a gated MLP or a Mixture-of-Experts layer (the
dense families yi-6b, stablelm-1.6b, qwen2-72b and minicpm-2b; the MoE
families granite-moe-1b-a400m and llama4-scout-17b-a16e; qwen2-vl-72b,
whose training forward takes M-RoPE positions):

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
would copy every weight each step.  SSM, xLSTM, shared-attention and
enc-dec models are later slices and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig

Params = Any
_BLOCKS_ITEM = "see ROADMAP.md, queue 1, slice 5: the other block kinds"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    why = None
    if cfg.is_encdec:
        why = "encoder-decoder models"
    elif cfg.shared_attn_every:
        why = "shared attention blocks (zamba2)"
    elif not kinds <= {"attn", "attn_local"}:
        why = f"block kinds {sorted(kinds - {'attn', 'attn_local'})}"
    elif not cfg.d_ff and not cfg.n_experts:
        why = "blocks with neither a gated MLP nor experts"
    if why is not None:
        raise NotImplementedError(f"{cfg.name}: {why} are not ported yet "
                                  f"({_BLOCKS_ITEM})")


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



def _shape_tree(cfg: ModelConfig) -> dict:
    """Nested dicts of shape tuples, the layout of ``init_params``."""
    _check_supported(cfg)
    d = cfg.d_model
    layer = {
        "ln1": cm.norm_shapes(cfg.norm, d),
        "attn": attn.attention_shapes(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                      qkv_bias=cfg.qkv_bias),
        "ln2": cm.norm_shapes(cfg.norm, d),
    }
    if cfg.n_experts:
        layer["moe"] = moe_mod.moe_shapes(d, cfg.d_ff_expert, cfg.n_experts)
    else:
        layer["mlp"] = mlp_mod.gated_mlp_shapes(d, cfg.d_ff)
    tree = {"embed": {"table": (cfg.vocab_size, d)},
            "final_norm": cm.norm_shapes(cfg.norm, d)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (d, cfg.vocab_size)}
    if cfg.value_head:
        tree["value_head"] = {"w": (d, 1)}
    tree["layers"] = [layer] * cfg.n_layers     # shared, never mutated
    return tree


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Flat {"layers.3.attn.wq.w": shape, ...} of every parameter."""
    return flatten(_shape_tree(cfg))


def _leaf_keys(cfg: ModelConfig, seed: int, partitionable: bool) -> dict:
    """{path: key} of every random leaf, the key tree of
    ``repro/models/model.py::init_params``: split(key(seed), n_layers + 5),
    the last three keys for the embedding, the LM head and the value head,
    key i for layer i, split in four there (attention, then the MLP or the
    experts), then in four (wq, wk, wv, wo) and three (gate, up, down), or
    four (router, w_gate, w_up, w_down: ``init_moe``'s split).  On the
    CPU: a few hundred tiny hashes."""
    def split(k, n):
        return prng.split(k, n, partitionable=partitionable)
    keys = split(prng.key(seed), cfg.n_layers + 5)
    out = {"embed.table": keys[-1], "lm_head.w": keys[-2],
           "value_head.w": keys[-3]}
    for i in range(cfg.n_layers):
        ks = split(keys[i], 4)
        for name, k in zip(("wq", "wk", "wv", "wo"), split(ks[0], 4)):
            out[f"layers.{i}.attn.{name}.w"] = k
        if cfg.n_experts:
            for name, k in zip(moe_mod.LEAVES, split(ks[1], 4)):
                out[f"layers.{i}.moe.{name}"] = k
            continue
        for name, k in zip(("gate", "up", "down"), split(ks[1], 3)):
            out[f"layers.{i}.mlp.{name}.w"] = k
    return out


def _init_std(cfg: ModelConfig, path: str, shape: tuple) -> float:
    """Spread of a random leaf: embeddings 0.02, the experts'
    ``init_moe`` spreads (router 0.02, w_gate and w_up 1/sqrt(d_model),
    w_down 1/sqrt(d_ff_expert)), linears 1/sqrt(d_in)."""
    parts = path.split(".")
    if parts[-1] == "table":
        return 0.02
    if len(parts) >= 2 and parts[-2] == "moe":
        return moe_mod.init_std(parts[-1], cfg.d_model, cfg.d_ff_expert)
    return cm.linear_std(shape[0])


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32, *,
                partitionable: bool = True) -> Params:
    """The JAX package's ``init_params(cfg, jax.random.key(seed))``, layers
    unstacked: a normal truncated at +-2 times each leaf's spread
    (``_init_std``), drawn by ``prng`` from the reference's key tree
    (``partitionable``: the threefry counter layout, see ``prng``); biases
    zero, norm scales one, norm biases zero.  Matrices are drawn in f32 and
    stored in ``dtype`` (pass the compute dtype to build serving weights
    directly on the card); 1-D parameters stay f32.  They agree with
    jax's within a few f32 ulps (``prng.truncated_normal``)."""
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
            fill = 1.0 if name == "scale" else 0.0
            flat[path] = torch.full(shape, fill, dtype=torch.float32,
                                    device=dev)
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


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               paged: Optional[attn.PagedLayout] = None) -> dict:
    """One KV cache of ``dtype`` (f32, bf16, or int8 with f32 row scales)
    per layer (the JAX package's ``kv_dtype``: the port has no recurrent
    state to keep apart).  Sliding-window layers keep a ring of
    min(cache_len, window) rows.  Under the ``decode_cp`` rules a layer
    whose length divides over the ranks holds only this rank's slice of
    it (``attention.init_kv_cache``).  With ``paged`` every global
    (``attn``) layer takes the page-pool layout, all of them behind one
    page table, which the cache also holds as ``pt``; ring layers stay
    contiguous."""
    _check_supported(cfg)
    dev = resolve(device)
    cache: Dict[str, Any] = {}
    if paged is not None and "attn" in cfg.layer_kinds():
        cache["pt"] = torch.full((batch, cache_len // paged.page_size), -1,
                                 dtype=torch.int32, device=dev)
    layers: List[dict] = []
    for kind in cfg.layer_kinds():
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
    return cache


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill block-writes KV caches; recurrent states need their
    own scans (and are not ported)."""
    return (not cfg.is_encdec
            and not cfg.shared_attn_every
            and all(k in ("attn", "attn_local") for k in cfg.layer_kinds()))


def _embed_inputs(cfg: ModelConfig, params: Params,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = cm.embed(params["embed"], batch["tokens"])
    return x.to(compute_dtype(cfg))


def _ffn_half(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The block's second residual half: (x + FFN(norm(x)), the experts'
    load-balance loss or None).  The FFN is the experts where the config
    has them (their capacity is per call: every row of the call, padding
    and idle slots included, competes for it, as in the JAX steps), the
    gated MLP otherwise."""
    y = cm.apply_norm(cfg.norm, p["ln2"], x)
    if cfg.n_experts:
        y, lb = moe_mod.moe_apply(p["moe"], y, top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  act=cfg.act)
        return x + y, lb
    return x + mlp_mod.gated_mlp(p["mlp"], y, act=cfg.act), None


def _rope_tables(cfg: ModelConfig, batch: Dict[str, torch.Tensor], s: int,
                device) -> tuple:
    """(cos, sin) of the training forward, as the JAX ``_rope_tables``:
    M-RoPE from batch["positions"] (3, B, S) where the config has
    sections (``arange(S)`` on all three axes without them), plain RoPE
    at 0 .. S-1 otherwise."""
    if cfg.mrope_sections is not None:
        pos = batch.get("positions")
        if pos is None:
            b = batch.get("tokens", batch.get("embeds")).shape[0]
            pos = torch.arange(s, device=device)[None, None].expand(3, b, s)
        return cm.mrope_cos_sin(pos.to(device), cfg.hd, cfg.rope_theta,
                                cfg.mrope_sections)
    return cm.rope_cos_sin(torch.arange(s, device=device)[None], cfg.hd,
                           cfg.rope_theta)


def _heads(cfg: ModelConfig, params: Params, x: torch.Tensor) -> dict:
    x = cm.apply_norm(cfg.norm, params["final_norm"], x)
    out = {}
    if cfg.tie_embeddings:
        out["logits"] = x @ params["embed"]["table"].T.to(x.dtype)
    else:
        out["logits"] = cm.linear(params["lm_head"], x, dtype=x.dtype)
    if cfg.value_head:
        out["value"] = cm.linear(params["value_head"], x)[..., 0].float()
    return out


def _block_train(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                 aux: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """One residual block over the full sequence -> (x, aux plus the
    block's load-balance loss).  ``p`` holds the f32 masters; the cast to
    the compute dtype happens here, so under ``cfg.remat`` it is
    recomputed in the backward and only one block's cast copies are alive
    at a time.  The recomputation routes the tokens as the forward did:
    top-k is a stable sort."""
    p = cast_params(cfg, p)
    h = attn.attend_train(p["attn"], cm.apply_norm(cfg.norm, p["ln1"], x),
                          cos, sin, cfg, window=_window(cfg, kind))
    x, lb = _ffn_half(cfg, p, x + h)
    return x, (aux if lb is None else aux + lb)


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Training (full-sequence) forward.  batch {"tokens": (B, S)} (or
    {"embeds": (B, S, d)}), with {"positions": (3, B, S)} for M-RoPE;
    ``params`` the f32 masters.  Returns {"logits" (B, S, V) in the
    compute dtype, "value" (B, S) f32, "aux_loss" () f32: the experts'
    load-balance losses summed over the layers, 0 without experts}.
    With ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    (the counterpart of ``jax.checkpoint``): its activations are
    recomputed in the backward."""
    _check_supported(cfg)
    # gather, then cast: the values of casting the table first
    x = _embed_inputs(cfg, params, batch)
    cos, sin = _rope_tables(cfg, batch, x.shape[1], x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.layer_kinds(), params["layers"]):
        if cfg.remat:
            x, aux = checkpoint(_block_train, cfg, kind, p, x, aux, cos, sin,
                                use_reentrant=False)
        else:
            x, aux = _block_train(cfg, kind, p, x, aux, cos, sin)
    top = cast_params(cfg, {k: v for k, v in params.items()
                            if k != "layers"})
    out = _heads(cfg, top, x)
    out["aux_loss"] = aux
    return out


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                batch: Dict[str, torch.Tensor], pos: torch.Tensor):
    """One-token decode.  batch {"tokens": (B, 1)}; pos the current absolute
    position, a lockstep scalar or per slot (B,).  ``params`` already cast
    (``cast_params``).  Writes the caches in place; returns (out, cache)."""
    _check_supported(cfg)
    x = _embed_inputs(cfg, params, batch)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    paged = attn.model_paged_index(cache, pos=pos)
    for kind, p, c in zip(cfg.layer_kinds(), params["layers"],
                          cache["layers"]):
        h, _ = attn.attend_decode(
            p["attn"], cm.apply_norm(cfg.norm, p["ln1"], x), c, pos, cfg,
            window=_window(cfg, kind), paged=paged)
        x = _ffn_half(cfg, p, x + h)[0]
    return _heads(cfg, params, x), cache


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
            f"{cfg.name}: chunked prefill needs attention-only caches")
    _check_supported(cfg)
    x = _embed_inputs(cfg, params, batch)
    paged = attn.model_paged_index(cache, pos0=pos0, c=x.shape[1],
                                   true_len=true_len)
    for kind, p, c in zip(cfg.layer_kinds(), params["layers"],
                          cache["layers"]):
        h, _ = attn.attend_prefill(
            p["attn"], cm.apply_norm(cfg.norm, p["ln1"], x), c, pos0, cfg,
            window=_window(cfg, kind), true_len=true_len, paged=paged)
        x = _ffn_half(cfg, p, x + h)[0]
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
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"{cfg.name}: speculative verify needs attention-only caches")
    _check_supported(cfg)
    x = _embed_inputs(cfg, params, batch)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    paged = attn.model_paged_index(cache, pos=pos, c=x.shape[1], verify=True)
    pendings = []
    for kind, p, c in zip(cfg.layer_kinds(), params["layers"],
                          cache["layers"]):
        h, pend = attn.attend_verify(
            p["attn"], cm.apply_norm(cfg.norm, p["ln1"], x), c, pos, cfg,
            shift=shift, window=_window(cfg, kind), paged=paged)
        pendings.append(pend)
        x = _ffn_half(cfg, p, x + h)[0]
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
