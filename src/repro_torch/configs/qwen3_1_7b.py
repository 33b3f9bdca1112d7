"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm [hf:Qwen/Qwen3-1.7B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    layer_pattern=("attn",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("attn",),
    qk_norm=True,
    tie_embeddings=True,
)
