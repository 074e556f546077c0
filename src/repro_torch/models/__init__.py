"""The LM family of the port (counterpart of ``repro.models``): the shared
blocks (``common.py``), attention with its KV cache (``attention.py``) and
the decoder-only transformer (``transformer.py``).  The MoE FFN, the
recsys and GNN models come with later slices (ROADMAP Queue 1, item 12)."""
