"""The model zoo of the port: the reference's ten architectures' forward,
prefill and decode in PyTorch (``repro.models``' counterpart).

Training (``chunked_ce_loss``, the optimizer and the train step) is the
next slice of the port."""
from .model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_from_hidden,
    param_count_exact,
)

__all__ = [
    "LM", "decode_step", "forward", "init_cache", "init_params",
    "logits_from_hidden", "param_count_exact",
]
