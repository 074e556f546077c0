"""ℓ0-sampling sketch kernel family of the turnstile runtime, with the
same split as ``count_sketch/``: ``ops.py`` the wrappers and parameters,
``ref.py`` the plain version, ``csrc/l0_sampler.cu`` the kernel K3."""

from repro_torch.kernels.l0_sampler.ops import (
    L0Params,
    canonicalize_edges,
    edge_cells,
    edge_fingerprint,
    edge_level,
    l0_delta,
    l0_sketch_shape,
    l0_update,
    make_l0_params,
)

__all__ = [
    "L0Params",
    "canonicalize_edges",
    "edge_cells",
    "edge_fingerprint",
    "edge_level",
    "l0_delta",
    "l0_sketch_shape",
    "l0_update",
    "make_l0_params",
]
