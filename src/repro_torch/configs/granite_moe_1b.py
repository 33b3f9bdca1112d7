"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) expert
d_ff=512 vocab=49155; 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    layer_pattern=("attn",),
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="granite-moe-1b-a400m-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab=512,
    layer_pattern=("attn",),
    n_experts=8,
    top_k=4,
    moe_d_ff=64,
    tie_embeddings=True,
)
