"""Serving of the port (counterpart of ``repro.serve``): the LM's
continuous-batching engine over a fixed-slot KV cache, the seed-batched
densest-subgraph query engine with its resilience policy, and the turnstile
density service."""

from repro_torch.serve.densest import DensestQueryEngine, QueryResult
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.resilience import CircuitBreaker, ResilienceConfig
from repro_torch.serve.turnstile import TurnstileDensityService

__all__ = [
    "CircuitBreaker", "DensestQueryEngine", "QueryResult", "Request",
    "ResilienceConfig", "ServeEngine", "TurnstileDensityService",
]
