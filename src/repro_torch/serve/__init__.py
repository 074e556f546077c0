"""Serving of the port's LM family (counterpart of ``repro.serve.engine``):
the continuous-batching engine over a fixed-slot KV cache."""

from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
