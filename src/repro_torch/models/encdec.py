"""Whisper-style encoder-decoder backbone, as ``repro/models/encdec.py``.

The mel-spectrogram and conv front end is a stub there and here:
``batch["enc_frames"]`` carries the frame embeddings (B, F, d_model).  The
bidirectional encoder runs through the flash kernels (``causal=False``),
the decoder's self attention through them too (causal) and, when it
decodes, through the decode kernel; its cross attention over the encoder
memory is plain products (``attention.cross_attend``), as the
reference's.  Positions are sinusoids, computed in f32 on the device of
their positions, as the reference computes them.  ``model.forward``,
``init_cache`` and ``decode_step`` route here when ``cfg.is_encdec``;
``forward`` takes the f32 masters (or this rank's shards under a layout)
and casts and gathers a block at a time, the serving functions take
parameters cast once (``model.cast_params``).  The embedding and the
heads are the model layer's (``model._sp_inputs``, ``model._heads``).

Under tensor and sequence parallelism (``forward`` under a
tensor-parallel layout) the encoder's residual is this rank's F / tp
frames and the decoder's its S / tp tokens, each with the sinusoids of
its own positions; every attention (self and cross) and the MLP run on
this rank's heads and d_ff columns over the gathered sequence
(``common.on_sequence``), and the encoder's output is gathered along the
frames once, for every decoder layer's cross-attention K/V.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.distributed import collectives, fsdp
from repro_torch.kernels import kv_quant
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def sinusoid_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Rows at positions ``pos`` (n,) of the sinusoid table (n, d) f32,
    sin on the even features and cos on the odd ones (the reference's
    ``at[:, 0::2]`` / ``at[:, 1::2]``), computed on ``pos``'s device: no
    copy to or from the host."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)[None]
    ang = pos.float()[:, None] / torch.pow(10000.0, dim / d)
    pe = torch.zeros((ang.shape[0], d), device=pos.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _sinusoid(s: int, d: int, device, start: int = 0) -> torch.Tensor:
    """Rows ``start`` .. ``start + s - 1`` of the sinusoid table."""
    return sinusoid_rows(torch.arange(start, start + s, device=device), d)


def shape_tree(cfg) -> dict:
    """``encdec.init_params``'s layout; every attention has q/k/v biases."""
    d = cfg.d_model

    def att():
        return attn.attention_shapes(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                     qkv_bias=True)
    norm = cm.norm_shapes(cfg.norm, d)
    enc = {"ln1": norm, "attn": att(), "ln2": norm,
           "mlp": mlp_mod.mlp_shapes(d, cfg.d_ff)}
    dec = {"ln1": norm, "self_attn": att(), "ln_x": norm,
           "cross_attn": att(), "ln2": norm,
           "mlp": mlp_mod.mlp_shapes(d, cfg.d_ff)}
    tree = {"embed": {"table": (cfg.vocab_size, d)},
            "enc_layers": [enc] * cfg.encoder_layers,
            "dec_layers": [dec] * cfg.n_layers,
            "enc_norm": norm, "final_norm": norm}
    if cfg.value_head:
        tree["value_head"] = {"w": (d, 1)}
    return tree


def leaf_keys(cfg, root: torch.Tensor, split) -> Dict[str, torch.Tensor]:
    """{path: key} of every random leaf, the reference's key tree:
    split(root, n_enc + n_dec + 4), the last key for the embedding and
    the one before for the value head, key i for encoder layer i (split
    in 2: attention, MLP) and key n_enc + i for decoder layer i (split in
    3: self attention, cross attention, MLP); an attention splits in 4
    (wq, wk, wv, wo), an MLP in 2 (fc1, fc2)."""
    n_enc = cfg.encoder_layers
    keys = split(root, n_enc + cfg.n_layers + 4)
    out = {"embed.table": keys[-1], "value_head.w": keys[-2]}

    def attention(prefix, k):
        for name, kk in zip(("wq", "wk", "wv", "wo"), split(k, 4)):
            out[f"{prefix}.{name}.w"] = kk

    def mlp(prefix, k):
        for name, kk in zip(("fc1", "fc2"), split(k, 2)):
            out[f"{prefix}.{name}.w"] = kk
    for i in range(n_enc):
        ks = split(keys[i], 2)
        attention(f"enc_layers.{i}.attn", ks[0])
        mlp(f"enc_layers.{i}.mlp", ks[1])
    for i in range(cfg.n_layers):
        ks = split(keys[n_enc + i], 3)
        attention(f"dec_layers.{i}.self_attn", ks[0])
        attention(f"dec_layers.{i}.cross_attn", ks[1])
        mlp(f"dec_layers.{i}.mlp", ks[2])
    return out


def _dtype(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def _keep(prefix: str, p):
    return p


def encode(cfg, params, frames: torch.Tensor, tp=None,
           prep=_keep) -> torch.Tensor:
    """frames (B, F, d_model), the stub's output -> the bidirectional
    encoder's memory (B, F, d_model).  ``prep(prefix, leaves)``: a layer's
    leaves as it computes on them (``forward``'s cast and gather).  Under
    tensor and sequence parallelism (``tp``) the residual is this rank's
    frames, and the memory is gathered whole along them at the end (the
    backward sums the ranks' partial cotangents: each rank's cross
    attention reads it through its own heads)."""
    x = frames.to(_dtype(cfg))
    start = 0
    if tp is not None:
        f = x.shape[1]
        if f % tp.size:
            raise ValueError(f"{cfg.name}: {f} encoder frames do not divide "
                             f"over the {tp.size} model ranks of the "
                             "sequence-parallel residual")
        start = tp.rank * (f // tp.size)
        x = x.narrow(1, start, f // tp.size)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device,
                      start).to(x.dtype)[None]
    for i, lyr in enumerate(params["enc_layers"]):
        lyr = prep(f"enc_layers.{i}", lyr)
        x = x + cm.on_sequence(lambda h: attn.attend_train(
            lyr["attn"], h, None, None, cfg, use_rope=False,
            bidirectional=True, tp=tp),
            cm.norm_rows(cfg.norm, lyr["ln1"], x, tp), tp)
        x = x + mlp_mod.mlp(lyr["mlp"], cm.norm_rows(cfg.norm, lyr["ln2"], x,
                                                     tp), act=cfg.act, tp=tp)
    mem = cm.norm_rows(cfg.norm, params["enc_norm"], x, tp)
    if tp is not None:
        mem = collectives.gather_sum(mem, tp.group, 1)
    return mem


_LAYERS = ("enc_layers", "dec_layers")


def forward(cfg, params, batch, layout=None) -> dict:
    """batch {"tokens": (B, S), "enc_frames": (B, F, d_model)} ->
    {"logits", "value", "aux_loss" (0)}; under a tensor-parallel layout
    the logits are this rank's vocab columns where the vocab is split
    (``model._heads``).  ``params``: the f32 masters, or this rank's shards
    under ``layout``, cast and gathered a layer at a time (the
    encoder-decoder has no remat, as in the reference)."""
    from repro_torch.models import model as M
    if "enc_frames" not in batch:
        raise KeyError(f"{cfg.name}: an encoder-decoder batch needs "
                       "'enc_frames' (B, F, d_model)")
    tp = fsdp.tp_rule(layout)

    def prep(prefix, p):
        return fsdp.gather(layout, prefix, M.cast_params(cfg, p),
                           model=tp is None)
    top = fsdp.gather(layout, "", {k: v for k, v in params.items()
                                   if k not in _LAYERS})
    mem = encode(cfg, {**top, "enc_layers": params["enc_layers"]},
                 batch["enc_frames"], tp, prep)
    if tp is None:
        x = M._embed_inputs(cfg, top, batch)
        start = 0
    else:
        x = M._sp_inputs(cfg, top, batch, tp)
        start = tp.rank * x.shape[1]
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device,
                      start).to(x.dtype)[None]
    for i, lyr in enumerate(params["dec_layers"]):
        lyr = prep(f"dec_layers.{i}", lyr)
        mkv = attn.memory_kv(lyr["cross_attn"], mem, cfg)
        x = x + cm.on_sequence(lambda h: attn.attend_train(
            lyr["self_attn"], h, None, None, cfg, use_rope=False, tp=tp),
            cm.norm_rows(cfg.norm, lyr["ln1"], x, tp), tp)
        x = x + cm.on_sequence(lambda h: attn.cross_attend(
            lyr["cross_attn"], h, mkv, cfg, tp=tp),
            cm.norm_rows(cfg.norm, lyr["ln_x"], x, tp), tp)
        x = x + mlp_mod.mlp(lyr["mlp"], cm.norm_rows(cfg.norm, lyr["ln2"], x,
                                                     tp), act=cfg.act, tp=tp)
    out = M._heads(cfg, M.cast_params(cfg, top), x, tp)
    out["aux_loss"] = torch.zeros((), dtype=torch.float32, device=x.device)
    return out


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """{"self": one KV cache a decoder layer, "cross": the encoder
    memory's K/V a layer, (B, encoder_seq, Hkv, D)}, all of ``dtype`` (the
    reference's encoder-decoder cache takes no int8: an int8 request makes
    it f32)."""
    dtype = kv_quant.resolve_kv_dtype(dtype)
    if kv_quant.is_quantized(dtype):
        dtype = torch.float32
    shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    cross: List[dict] = [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]
    return {"self": [attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads,
                                        cfg.hd, dtype, device)
                     for _ in range(cfg.n_layers)],
            "cross": cross}


def prefill_cross(cfg, params, cache: dict, frames: torch.Tensor) -> dict:
    """Run the encoder once and write every layer's cross-attention K/V
    into the cache, in place.  Returns the cache."""
    mem = encode(cfg, params, frames)
    for lyr, c in zip(params["dec_layers"], cache["cross"]):
        k, v = attn.memory_kv(lyr["cross_attn"], mem, cfg)
        c["k"].copy_(k)
        c["v"].copy_(v)
    return cache


def decode_step(cfg, params, cache: dict, batch, pos, tp=None):
    """One decoder token a row: batch {"tokens": (B, 1)}, pos a lockstep
    scalar or per row (B,); the sinusoid at each row's pos.  Writes the
    self-attention caches in place; returns (out, cache).  Under the
    serving layout (``tp``, ``fsdp.TPRule``) every attention and the MLP
    run on this rank's heads and d_ff columns, their partial sums summed
    over the model group (the embedding and the heads as
    ``model.decode_step``'s); the self-attention caches and the cross
    memory are laid out by ``sharding.cache_shardings``."""
    from repro_torch.models import model as M
    x = M._decode_inputs(cfg, params, batch, tp).to(_dtype(cfg))
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    x = x + sinusoid_rows(pos, cfg.d_model).to(x.dtype)[:, None]

    def summed(y):
        return y if tp is None else collectives.sum_partials(y, tp.group)
    for lyr, c, cx in zip(params["dec_layers"], cache["self"],
                          cache["cross"]):
        h, _ = attn.attend_decode(lyr["self_attn"],
                                  cm.apply_norm(cfg.norm, lyr["ln1"], x), c,
                                  pos, cfg, use_rope=False, tp=tp)
        x = x + summed(h)
        x = x + summed(attn.cross_decode(
            lyr["cross_attn"], cm.apply_norm(cfg.norm, lyr["ln_x"], x), cx,
            cfg, tp))
        x = x + mlp_mod.mlp_decode(lyr["mlp"],
                                   cm.apply_norm(cfg.norm, lyr["ln2"], x),
                                   act=cfg.act, tp=tp)
    return M.decode_heads(cfg, params, x, tp), cache
