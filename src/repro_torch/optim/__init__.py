"""The optimizer of the training path (counterpart of ``repro.optim``):
AdamW updating in place, gradient compression, LR schedules."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    Quantized,
    apply_updates,
    global_norm,
    init_state,
    opt_state_from_reference,
)
from repro_torch.optim.compression import (
    CompressionConfig,
    compress_decompress_psum,
    init_error_state,
)
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "CompressionConfig",
    "Quantized",
    "apply_updates",
    "compress_decompress_psum",
    "constant",
    "global_norm",
    "init_error_state",
    "init_state",
    "opt_state_from_reference",
    "warmup_cosine",
]
