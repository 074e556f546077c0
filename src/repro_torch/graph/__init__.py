from repro_torch.graph.edgelist import (
    EdgeList,
    apply_updates,
    dedup_edges,
    from_numpy,
    from_reference,
    resolve_device,
    to_csr,
)

__all__ = [
    "EdgeList", "apply_updates", "dedup_edges", "from_numpy", "from_reference",
    "resolve_device", "to_csr",
]
