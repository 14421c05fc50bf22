"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
fine-grained MoE: 32 experts, top-8, expert d_ff=512."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,                      # all FFN capacity lives in the experts
    vocab_size=49155,
    block_cycle=("attn",),
    n_experts=32,
    top_k=8,
    d_ff_expert=512,
    rope_theta=1e4,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
