"""The query a traffic mix sends, through the port's front door.

A traffic file names the call (``"query": "solve"`` or ``"solve_batch"``),
the ``Problem`` fields (``"problem"``) and, for a sweep, the eps list
(``"eps"``).  A query is one call into ``repro_torch.core.api.Solver``
that ends with the answer on the host: each lane's best set as the
program's bool mask, its density, its size and its passes, plus the
call's provenance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench import reference


class Result(NamedTuple):
    """What one query put on the host: one answer a lane and which cell of
    the front door ran (``None`` for the control, which has no front
    door)."""

    answers: Tuple[reference.Answer, ...]
    provenance: Optional[Dict[str, Any]]


def lane_eps(traffic: Dict[str, Any]) -> List[float]:
    """The eps of each lane: the sweep's list, or the Problem's one eps."""
    if traffic["query"] == "solve_batch":
        return [float(e) for e in traffic["eps"]]
    return [float(traffic["problem"].get("eps", 0.5))]


def max_passes(traffic: Dict[str, Any], n_nodes: int) -> int:
    """The trip bound the query's Problem states: Lemma 4's at its least eps."""
    explicit = traffic["problem"].get("max_passes")
    if explicit is not None:
        return int(explicit)
    return reference.max_passes_bound(n_nodes, min(lane_eps(traffic)))


def answers_on_host(best_alive: torch.Tensor, density: torch.Tensor, size: torch.Tensor,
                    passes: Sequence[int]) -> Tuple[reference.Answer, ...]:
    """Each lane's best set on the host as the program gives it, a bool
    mask over the nodes (one copy of N bytes a lane; ``check.py`` compares
    it with the reference's node ids), then the lanes' scalars."""
    lanes = len(passes)
    masks = best_alive.reshape(lanes, -1).cpu().numpy()
    dens = density.reshape(lanes).float().cpu().numpy()
    sizes = size.reshape(lanes).cpu().numpy()
    return tuple(
        reference.Answer(nodes=masks[b], density=float(dens[b]), size=int(sizes[b]),
                         passes=int(passes[b]))
        for b in range(lanes)
    )


def program_query(traffic: Dict[str, Any], graph, cache_dir: str) -> Callable[[], Result]:
    """The port's query: ``Solver(cache_dir).solve`` or ``.solve_batch``."""
    from repro_torch.core.api import Problem, Solver

    solver = Solver(cache_dir=cache_dir)
    problem = Problem(**traffic["problem"])
    if traffic["query"] == "solve":
        def call():
            return solver.solve(graph, problem)
    elif traffic["query"] == "solve_batch":
        eps = [float(e) for e in traffic["eps"]]

        def call():
            return solver.solve_batch(graph, problem, eps=eps)
    else:
        raise ValueError(f"unknown query {traffic['query']!r}")

    def query() -> Result:
        res = call()
        passes = res.passes if isinstance(res.passes, list) else [res.passes]
        answers = answers_on_host(res.best_alive, res.best_density, res.best_size, passes)
        return Result(answers=answers, provenance=dataclasses.asdict(res.provenance))

    return query


def control_query(traffic: Dict[str, Any], src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                  precision: str) -> Callable[[], Result]:
    """The control in the program's place: the reference peel, each lane
    in ``precision``."""
    eps = lane_eps(traffic)
    mp = max_passes(traffic, n_nodes)

    def query() -> Result:
        rep = reference.replay(src, dst, n_nodes, eps, mp, precision)
        return Result(answers=tuple(rep.answers), provenance=None)

    return query
