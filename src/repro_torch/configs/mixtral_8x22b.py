"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768; 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    layer_pattern=("local",),
    window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    moe_token_chunk=4,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("local",),
    window=16,
    n_experts=4,
    top_k=2,
    moe_d_ff=64,
    moe_token_chunk=2,
    tie_embeddings=False,
)
