"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000; alternating local(4096)/global attention, attention softcap
50, final-logit softcap 30, GeGLU [arXiv:2408.00118; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    layer_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
)

REDUCED = ModelConfig(
    name="gemma2-27b-reduced",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab=512,
    layer_pattern=("local", "attn"),
    window=16,
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
)
