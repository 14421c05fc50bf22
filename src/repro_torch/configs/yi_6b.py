"""Yi-6B [arXiv:2403.04652] — llama-arch dense with aggressive GQA (kv=4)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_cycle=("attn",),
    rope_theta=5e6,
    norm="rmsnorm",
    act="silu",
    source="arXiv:2403.04652",
)
