from repro_torch.graph.edgelist import (
    EdgeList,
    dedup_edges,
    from_numpy,
    from_reference,
    resolve_device,
)

__all__ = ["EdgeList", "dedup_edges", "from_numpy", "from_reference", "resolve_device"]
