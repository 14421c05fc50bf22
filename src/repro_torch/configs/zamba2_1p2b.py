"""Zamba2-1.2B [arXiv:2411.15242] — Mamba2 backbone + one shared
attention+MLP block applied every 6 layers (distinct KV per application)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                   # shared attention block's MLP
    vocab_size=32000,
    block_cycle=("mamba2",),
    shared_attn_every=6,
    ssm_state=64,
    ssm_heads=64,                # d_inner = 2*d_model = 4096 = 64 * 64
    ssm_head_dim=64,
    ssm_groups=1,
    rope_theta=1e4,
    tie_embeddings=True,
    norm="rmsnorm",
    act="gelu",
    source="arXiv:2411.15242",
)
