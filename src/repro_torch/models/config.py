"""Model configuration: one dataclass drives every backbone family.

A copy of ``repro/models/config.py``: configs are data, and the port
imports nothing of ``repro``.  ``param_count`` sums the port's own
parameter shapes.

A model is a stack of *blocks* described by ``block_cycle`` (a short pattern
tiled over ``n_layers``), plus embeddings and heads.  Block kinds:

  attn        global causal self-attention + FFN (gated MLP or MoE)
  attn_local  sliding-window / chunked-local attention + FFN
  mamba2      Mamba2 SSD block; + FFN unless zamba2's shared block is on
  mlstm       xLSTM matrix-memory block
  slstm       xLSTM scalar-memory block (true recurrence)

``shared_attn_every > 0`` (Zamba2) additionally applies a single *shared*
attention+FFN block after every k-th layer — same weights at every
application point, distinct KV caches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block_cycle: Tuple[str, ...] = ("attn",)
    source: str = ""                 # citation for the config

    norm: str = "rmsnorm"
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope: bool = True                # False: no positional encoding (NoPE)
    rotary_dim: Optional[int] = None  # partial rotary (StableLM-2: 25%)
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # window for attn_local blocks
    rms_norm_eps: float = 1e-6

    # Granite's multipliers: the embedding's rows, the softmax scale
    # (None: 1/sqrt(head_dim)), each branch into the residual, the logits'
    # divisor
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25    # 0: dropless (no capacity)
    aux_loss_weight: float = 0.01
    d_ff_shared: int = 0             # a shared expert's width (0: none)
    experts_held: int = 0            # experts 0 .. held-1 here (0: all)

    # SSM / xLSTM
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    lstm_expand: int = 2

    # hybrid (Zamba2)
    shared_attn_every: int = 0

    # VLM (Qwen2-VL M-RoPE)
    mrope_sections: Optional[Tuple[int, int, int]] = None

    # encoder-decoder (Whisper)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # audio frames after the (stubbed) conv

    # RL heads
    value_head: bool = True

    dtype: str = "bfloat16"
    remat: bool = True               # jax.checkpoint each block cycle in train

    # reduced smoke-variant factory -------------------------------------
    def reduced(self) -> "ModelConfig":
        """2-layer, d_model<=512, <=4-expert variant of the same family for
        CPU smoke tests (spec requirement)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads,
                          n_heads * self.n_kv_heads // self.n_heads)) or 1
        n_kv = max(1, min(n_kv, n_heads))
        cyc = len(self.block_cycle)
        n_layers = cyc if cyc >= 2 else 2
        n_layers = min(n_layers, 4)  # keep tiny but cover the cycle
        changes = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            d_ff_expert=min(self.d_ff_expert, 128),
            # no-drop capacity in smoke: batched prefill and step decode
            # must route identically for the consistency tests
            capacity_factor=8.0 if self.capacity_factor else 0.0,
            d_ff_shared=min(self.d_ff_shared, 128),
            experts_held=min(self.experts_held, 2),
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=16 if self.sliding_window else None,
            # rescale M-RoPE sections to the reduced head_dim (sum == hd/2)
            mrope_sections=(8, 12, 12) if self.mrope_sections else None,
            rotary_dim=16 if self.rotary_dim else None,
            dtype="float32",
            remat=False,
        )
        return dataclasses.replace(self, **changes)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def capacity_routed(self) -> bool:
        """Experts routed under a capacity, which couples a call's rows."""
        return bool(self.n_experts) and self.capacity_factor > 0

    @property
    def n_held(self) -> int:
        """The experts whose weights this model holds."""
        return self.experts_held or self.n_experts

    def has_ffn(self, kind: str) -> bool:
        """Whether a block of ``kind`` ends in the FFN half: attention
        blocks, and mamba2 blocks unless zamba2's shared block carries the
        model's FFN."""
        if kind in ("attn", "attn_local"):
            return True
        return kind == "mamba2" and not self.shared_attn_every

    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_cycle))
        return (self.block_cycle * reps)[: self.n_layers]

    def param_count(self) -> int:
        """Total params N, summed over the port's own parameter shapes."""
        import math

        from repro_torch.models import model as m
        return sum(math.prod(s) for s in m.param_shapes(self).values())

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = (3 * self.d_model * self.d_ff_expert)
        layers_with_moe = sum(1 for k in self.layer_kinds()
                              if self.has_ffn(k))
        inactive = (self.n_held - self.top_k) * per_expert * layers_with_moe
        return total - inactive
