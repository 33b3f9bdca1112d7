"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536;
Finch data-dependent decay [arXiv:2404.05892; hf].  40 heads of 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    layer_pattern=("rwkv",),
    tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="rwkv6-3b-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("rwkv",),
    tie_embeddings=False,
)
