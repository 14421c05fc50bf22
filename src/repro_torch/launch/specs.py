"""Input and parameter stand-ins for every (architecture x input shape),
as ``repro/launch/specs.py``: tensors on the meta device (shapes and
dtypes, no storage) where the reference has ``ShapeDtypeStruct``s.

``input_specs(cfg, shape_id)`` returns (kind, specs): kind is "train",
"prefill" or "decode", and specs has the keys, shapes and dtypes of what
the train step, the forward and the serve step take.  A decode shape is
ONE new token against a cache of ``seq`` rows (the RL actor's path): the
cache is the port's ``init_cache(cfg, batch, seq, dtype=bf16)`` on the
meta device, and the PRNG key the port's ``prng`` key, two int64 words.
``long_500k`` needs sub-quadratic attention, which the dense archs get
through their sliding-window variant (``maybe_long_variant``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

META = torch.device("meta")

INPUT_SHAPES = {
    "train_4k":    dict(seq=4_096,   batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768,  batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32_768,  batch=128, kind="decode"),
    "long_500k":   dict(seq=524_288, batch=1,   kind="decode"),
}

# long_500k: native sub-quadratic for the SSM, hybrid and chunked-local
# archs; the dense archs and the VLM run the sliding-window variant;
# whisper (a bounded decoder context) is skipped
LONG_DECODE = {
    "qwen2-72b": "sw",
    "minicpm-2b": "sw",
    "yi-6b": "sw",
    "granite-moe-1b-a400m": "sw",
    "whisper-base": None,
    "zamba2-1.2b": "native",
    "xlstm-1.3b": "native",
    "llama4-scout-17b-a16e": "native",
    "qwen2-vl-72b": "sw",
    "stablelm-1.6b": "sw",
}

SW_WINDOW = 8_192


def sliding_window_variant(cfg: ModelConfig) -> ModelConfig:
    """A dense arch -> its all-local-attention variant for long-context
    decode."""
    return dataclasses.replace(
        cfg, name=cfg.name + "+sw",
        block_cycle=tuple("attn_local" if k == "attn" else k
                          for k in cfg.block_cycle),
        sliding_window=SW_WINDOW)


def maybe_long_variant(cfg: ModelConfig, shape_id: str) -> ModelConfig:
    if shape_id == "long_500k" and LONG_DECODE.get(cfg.name) == "sw":
        return sliding_window_variant(cfg)
    return cfg


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, b: int, s: int) -> Dict[str, Any]:
    if cfg.family == "vlm":
        # the vision stub: precomputed embeddings and M-RoPE position ids
        return {"embeds": _spec((b, s, cfg.d_model), torch.bfloat16),
                "positions": _spec((3, b, s), torch.int32)}
    return {"tokens": _spec((b, s), torch.int32)}


def input_specs(cfg: ModelConfig, shape_id: str
                ) -> Tuple[str, Dict[str, Any]]:
    sh = INPUT_SHAPES[shape_id]
    b, s, kind = sh["batch"], sh["seq"], sh["kind"]
    if kind in ("train", "prefill"):
        batch = _token_batch(cfg, b, s)
        if cfg.is_encdec:
            batch["enc_frames"] = _spec((b, cfg.encoder_seq, cfg.d_model),
                                        torch.bfloat16)
        if kind == "train":
            if cfg.family == "vlm":
                batch["actions"] = _spec((b, s), torch.int32)
            batch["rewards"] = _spec((b, s), torch.float32)
            batch["discounts"] = _spec((b, s), torch.float32)
        return kind, batch
    batch = _token_batch(cfg, b, 1)
    cache = M.init_cache(cfg, b, s, dtype=torch.bfloat16, device=META)
    # per-slot decode positions and a threaded key (the engine folds the
    # step index in; the serve step folds the row per slot)
    return kind, {"batch": batch, "cache": cache,
                  "pos": _spec((b,), torch.int32),
                  "key": _spec((2,), torch.int64)}


def params_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree (``init_params``' layout and f32 dtype) on the
    meta device."""
    return M.unflatten({k: _spec(shape, torch.float32)
                        for k, shape in M.param_shapes(cfg).items()})
