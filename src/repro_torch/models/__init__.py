"""The model zoo of the port: the reference's ten architectures' forward,
prefill, decode and training loss in PyTorch (``repro.models``'
counterpart).  The optimizer and the train step are ``repro_torch.train``."""
from .model import (
    LM,
    chunked_ce_loss,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_from_hidden,
    param_count_exact,
)

__all__ = [
    "LM", "chunked_ce_loss", "decode_step", "forward", "init_cache", "init_params",
    "logits_from_hidden", "param_count_exact",
]
