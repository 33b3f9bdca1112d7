"""--arch registry: maps architecture ids to (full, reduced) configs."""
from __future__ import annotations

from . import (
    gemma2_27b,
    granite_moe_1b,
    hubert_xlarge,
    internlm2_20b,
    internvl2_26b,
    mixtral_8x22b,
    qwen3_1_7b,
    recurrentgemma_2b,
    rwkv6_3b,
    stablelm_12b,
)
from .base import ModelConfig, shape_cells

_MODULES = {
    "internvl2-26b": internvl2_26b,
    "stablelm-12b": stablelm_12b,
    "qwen3-1.7b": qwen3_1_7b,
    "internlm2-20b": internlm2_20b,
    "gemma2-27b": gemma2_27b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-3b": rwkv6_3b,
    "mixtral-8x22b": mixtral_8x22b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "hubert-xlarge": hubert_xlarge,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.CONFIG


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Apply the reference's skip rules (pure full-attention long_500k,
    encoder-only decode)."""
    cfg = get_config(arch)
    cell = shape_cells()[shape]
    if cfg.encoder_only and cell["kind"] == "decode":
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k":
        # runs only when every block is sub-quadratic in context (SSM, RG-LRU,
        # windowed attention); any unbounded full-attention block disqualifies
        if "attn" in cfg.layer_pattern or "bidir" in cfg.layer_pattern:
            return False, (
                "long_500k needs sub-quadratic attention; arch has unbounded "
                "full-attention blocks"
            )
    return True, ""
