"""The port's core: the front door (api.py) over the peel engine (engine.py),
the §5.1 Count-Sketch backend (countsketch.py) and the turnstile runtime
(turnstile.py).

    from repro_torch.core import Problem, solve
    res = solve(edges, Problem.undirected(eps=0.5, backend="pallas"))
"""

from repro_torch.core.api import DenseSubgraphResult, Problem, Provenance, Solver, solve
from repro_torch.core.countsketch import (
    SketchBackend,
    densest_subgraph_sketched,
    make_sketch_params,
    query_degrees,
    sketch_degrees_from_edges,
)
from repro_torch.core.turnstile import TurnstileDensest, TurnstileSketch

__all__ = [
    "DenseSubgraphResult",
    "Problem",
    "Provenance",
    "SketchBackend",
    "Solver",
    "TurnstileDensest",
    "TurnstileSketch",
    "densest_subgraph_sketched",
    "make_sketch_params",
    "query_degrees",
    "sketch_degrees_from_edges",
    "solve",
]
