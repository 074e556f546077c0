"""The model families of the port (counterpart of ``repro.models``): the
shared blocks and segment ops (``common.py``), attention with its KV cache
(``attention.py``), the MoE FFN (``moe.py``), the decoder-only transformer
(``transformer.py``), the two-tower recsys model (``recsys.py``) and the
GNNs (``gnn/``)."""
