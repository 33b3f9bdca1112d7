"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention 1:2 (rec, rec, local-attn)
[arXiv:2402.19427; hf].  Window 2048, lru width = d_model."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    layer_pattern=("rec", "rec", "local"),
    window=2048,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    d_rnn=2560,
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("rec", "rec", "local"),
    window=16,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    d_rnn=64,
)
