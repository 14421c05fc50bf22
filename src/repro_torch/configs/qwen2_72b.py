"""Qwen2-72B [arXiv:2407.10671] — dense GQA decoder, QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
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
    norm="rmsnorm",
    act="silu",
    source="arXiv:2407.10671",
)
