"""The port's core: the front door (api.py) over the peel engine (engine.py).

    from repro_torch.core import Problem, solve
    res = solve(edges, Problem.undirected(eps=0.5, backend="pallas"))
"""

from repro_torch.core.api import DenseSubgraphResult, Problem, Provenance, Solver, solve

__all__ = ["DenseSubgraphResult", "Problem", "Provenance", "Solver", "solve"]
