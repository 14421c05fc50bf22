"""xLSTM-1.3B [arXiv:2405.04517] — xLSTM[7:1]: 7 mLSTM blocks per sLSTM
block; no separate FFN (d_ff=0 — projections live inside the blocks)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_cycle=("mlstm",) * 7 + ("slstm",),
    lstm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
