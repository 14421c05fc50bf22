"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense; WSD lr schedule.

The WSD (warmup-stable-decay) schedule is the model's training-recipe
signature; it composes with the paper's per-worker LogUniform lr sampling in
repro.optim.schedules.wsd.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    block_cycle=("attn",),
    rope_theta=1e4,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    source="arXiv:2404.06395",
)
