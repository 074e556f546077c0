"""The GNN family of the port (counterpart of ``repro.models.gnn``):
GraphSAGE, EGNN, MACE and EquiformerV2 over the segment ops of
``models/common.py``, and the tile-partitioned neighbor sum (``dist.py``)."""
