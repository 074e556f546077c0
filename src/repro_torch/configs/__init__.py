"""Architecture configs of the port's LM family (counterpart of
``repro.configs``): the same ``ArchSpec`` records and numbers for the
archs the port runs.

    from repro_torch.configs import get_arch
    cfg = get_arch("llama3.2-3b").config
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec, lm_shapes
from repro_torch.configs.registry import all_archs, get_arch

__all__ = ["ArchSpec", "ShapeSpec", "all_archs", "get_arch", "lm_shapes"]
