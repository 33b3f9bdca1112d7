"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504;
encoder-only transformer backbone [arXiv:2106.07447; unverified].
The conv waveform frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings (feature dim 512); vocab is the masked-prediction
codebook.  No decode step (encoder-only)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    layer_pattern=("bidir",),
    act="gelu",
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="hubert-xlarge-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=64,
    layer_pattern=("bidir",),
    act="gelu",
    encoder_only=True,
    frontend="audio",
    frontend_dim=48,
    tie_embeddings=False,
)
