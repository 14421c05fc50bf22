"""Whisper-base [arXiv:2212.04356] — encoder-decoder; mel+conv frontend is a
STUB (input_specs supplies precomputed frame embeddings (B, 1500, 512))."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    is_encdec=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
