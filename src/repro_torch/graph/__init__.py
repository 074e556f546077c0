from repro_torch.graph.edgelist import (
    EdgeList,
    EdgeSpillWriter,
    apply_updates,
    dedup_edges,
    from_numpy,
    from_reference,
    open_edge_spill,
    open_edges_memmap,
    resolve_device,
    save_edges_memmap,
    to_csr,
)

__all__ = [
    "EdgeList", "EdgeSpillWriter", "apply_updates", "dedup_edges", "from_numpy",
    "from_reference", "open_edge_spill", "open_edges_memmap", "resolve_device",
    "save_edges_memmap", "to_csr",
]
