"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE
(16 experts, top-1) with iRoPE-style attention: 3 chunked-local layers per
global-attention layer.  Early fusion: forward also accepts precomputed
multimodal embeddings.  The HF shared-expert is folded into the routed
experts (noted in DESIGN.md §Arch-applicability)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=202048,
    block_cycle=("attn_local", "attn_local", "attn_local", "attn"),
    sliding_window=8192,
    n_experts=16,
    top_k=1,
    d_ff_expert=8192,
    rope_theta=5e5,
    norm="rmsnorm",
    act="silu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
