"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — dense, LayerNorm,
partial rotary (25% of head_dim)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    block_cycle=("attn",),
    rotary_dim=16,               # rope_pct = 0.25 of head_dim 64
    rope_theta=1e4,
    norm="layernorm",
    act="silu",
    source="hf:stabilityai/stablelm-2-1_6b",
)
