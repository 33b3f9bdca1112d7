"""Model / run configuration (the port's copy of ``repro.configs.base``).

One ``ModelConfig`` per assigned architecture lives in ``configs/<id>.py``;
``configs.registry`` maps ``--arch`` ids to them.  ``REDUCED`` in each is the
CPU-test version of the same family (same code paths, tiny dims).  The
shapes are the reference's, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Sub-block kinds usable in a layer pattern:
#   attn    -- full causal self-attention (+ mlp)
#   local   -- sliding-window causal attention (+ mlp), window = cfg.window
#   bidir   -- bidirectional attention (encoder-only archs) (+ mlp)
#   rec     -- RG-LRU recurrent block (+ mlp)
#   rwkv    -- RWKV6 time-mix + channel-mix (its own ffn)
# MoE archs replace the dense mlp in attn/local blocks with the MoE ffn.


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # sliding window size for 'local' blocks (0 = unused)
    qk_norm: bool = False
    attn_softcap: float = 0.0  # 0 disables
    logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_token_chunk: int = 0  # >0: scan the MoE over token chunks (bounds
    #                           the peak [E,C,D] dispatch buffers)
    # structure
    encoder_only: bool = False
    frontend: str = "none"  # none | vision | audio (stubbed patch/frame embeddings)
    frontend_tokens: int = 0  # prepended stub-embedding positions (vlm)
    frontend_dim: int = 0  # raw feature dim of the stub frontend input
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma-style sqrt(d_model) embedding scaling
    act: str = "silu"
    norm_eps: float = 1e-5
    d_rnn: int = 0  # RG-LRU width (0 -> d_model)
    conv_width: int = 4

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a TP-friendly multiple (Megatron-style vocab
        padding), as the reference pads it: the padded columns are masked
        out of the logits."""
        mult = 128
        return ((self.vocab + mult - 1) // mult) * mult

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def has_attention(self) -> bool:
        return any(k in ("attn", "local", "bidir") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over unbounded context quadratically.

        Used for the long_500k skip rule: pure full-attention archs skip it.
        """
        return "attn" not in self.layer_pattern and "bidir" not in self.layer_pattern

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    def layer_groups(self) -> list[tuple[Tuple[str, ...], int]]:
        """Split n_layers into (pattern, repeats) groups for scan-over-layers."""
        p = len(self.layer_pattern)
        full, rem = divmod(self.n_layers, p)
        groups = []
        if full:
            groups.append((self.layer_pattern, full))
        if rem:
            groups.append((self.layer_pattern[:rem], 1))
        return groups

    def param_count(self) -> int:
        """Exact parameter count, from the real init on the meta device."""
        from repro_torch.models.model import param_count_exact

        return param_count_exact(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts) for 6*N*D."""
        from repro_torch.models.model import param_count_exact

        total = param_count_exact(self)
        if not self.moe:
            return total
        expert = 3 * self.d_model * self.moe_d_ff
        n_blocks = sum(
            reps * sum(1 for k in pat if k in ("attn", "local", "bidir"))
            for pat, reps in self.layer_groups()
        )
        inactive = n_blocks * (self.n_experts - self.top_k) * expert
        return total - inactive


def shape_cells() -> dict:
    """The four assigned input-shape sets (seq_len, global_batch, kind)."""
    return {
        "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
        "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
        "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
        "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
    }
