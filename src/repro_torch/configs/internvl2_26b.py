"""internvl2-26b [vlm]: InternViT frontend (stub) + InternLM2-26B backbone.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf]
The vision frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings (InternViT-6B feature dim 3200) which a linear
projector maps into the LM stream.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    layer_pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=256,
    frontend_dim=3200,
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    layer_pattern=("attn",),
    tie_embeddings=False,
    frontend="vision",
    frontend_tokens=8,
    frontend_dim=48,
)
