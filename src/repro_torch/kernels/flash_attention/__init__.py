"""Flash-attention kernel family of the LM path, with the same split as the
other kernels: ``ops.py`` the wrapper, ``ref.py`` the plain version,
``csrc/flash_attention.cu`` the kernel K4."""

from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_trainable
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_trainable"]
