"""Qwen2-VL-72B [arXiv:2409.12191] — Qwen2-72B backbone with M-RoPE
(temporal/height/width sections) and dynamic-resolution vision input.  The
ViT encoder is a STUB: input_specs supplies precomputed patch embeddings
(B, S, d_model) plus (3, B, S) M-RoPE position ids."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_cycle=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm",
    act="silu",
    source="arXiv:2409.12191",
)
