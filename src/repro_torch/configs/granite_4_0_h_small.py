"""Granite-4.0-H-Small [hf:ibm-granite/granite-4.0-h-small] (32B-A9B,
``granitemoehybrid``) — 40 layers at d 4096 in a period of ten: Mamba-2
mixers (128 heads of 64, d_state 128, one group) on 36 and NoPE GQA
attention (32 / 8 heads of 128) on layers 5, 15, 25 and 35; after every
mixer a dropless MoE (72 experts of width 768, top-10) beside one shared
expert of width 1536; Granite's embedding, attention, residual and logit
multipliers; tied embeddings.  Not one of the ten JAX-parity configs
(``ARCH_IDS``): ``get_config("granite_4_0_h_small")``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,                      # the FFN is the experts and the shared one
    vocab_size=100352,
    block_cycle=("mamba2",) * 5 + ("attn",) + ("mamba2",) * 4,
    rope_theta=1e4,
    rope=False,                  # position_embedding_type "nope"
    tie_embeddings=True,
    rms_norm_eps=1e-5,
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    n_experts=72,
    top_k=10,
    d_ff_expert=768,
    capacity_factor=0.0,         # dropless
    d_ff_shared=1536,
    ssm_state=128,
    ssm_heads=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    act="silu",
    source="hf:ibm-granite/granite-4.0-h-small",
)
