"""The plain reference: Algorithm 1 of Bahmani, Kumar and Vassilvitskii
(PVLDB 5(5), 2012), written from the paper in plain PyTorch.

It imports nothing of the port and nothing of JAX.  One peel over an
unweighted undirected edge list (each edge once, ``src != dst``):

* a pass starts from the alive set S; it stops when S is empty or after
  ``max_passes`` passes;
* the induced degrees are exact integer counts (``torch.bincount``) and
  |E(S)| is an exact integer;
* rho(S) = |E(S)| / |S| and the threshold 2(1+eps)·rho(S) are formed in
  the configuration's precision (float32: the count and |S| rounded to
  float32, one division, one product by 2(1+eps) rounded to float32);
* the best set is the first S of the largest rho (strict ``>``);
* every node of S with degree <= the threshold leaves, and so does every
  node of the least degree in S (the rule that lets rounding never stall a
  pass).

``max_passes`` is the Lemma 4 bound, ceil(log_{1+eps} n) + 4, at least 8
and at most n + 1 (a sweep takes it at its least eps).  The run also
records, for every pass, |E(S)| and |S| at the pass's start: the work a
degree count needs, which ``metrics/degree_roofline_pct.py`` reads.

``precision='bfloat16'`` is the control: the same peel with the degrees,
rho and the threshold in bfloat16, the nearest precision below float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Answer(NamedTuple):
    """One lane's answer: the best set's node ids (sorted; the program's
    answer gives its bool mask over the nodes instead), its density as a
    float (the value in the run's precision), its size and the passes."""

    nodes: np.ndarray
    density: float
    size: int
    passes: int


@dataclasses.dataclass
class Replay:
    """A reference run: one :class:`Answer` a lane, and per lane the
    ``(|E(S)|, |S|)`` of every pass at its start."""

    answers: List[Answer]
    work: List[List[Tuple[int, int]]]


def max_passes_bound(n_nodes: int, eps: float, floor: int = 8) -> int:
    """Lemma 4's trip bound: ceil(log_{1+eps} n) + 4, in [floor, n + 1]."""
    if eps <= 0:
        return int(n_nodes) + 1
    bound = int(math.ceil(math.log(max(n_nodes, 2)) / math.log1p(eps))) + 4
    return max(floor, min(bound, int(n_nodes) + 1))


def _factor(eps: float, dtype: torch.dtype) -> torch.Tensor:
    """2(1+eps) in ``dtype``; the traffic's eps values make it exact in
    float32, where the scalar and the lane forms of the product agree."""
    f = 2.0 * (1.0 + eps)
    if float(np.float32(f)) != f or float(np.float32(eps)) != eps:
        raise ValueError(f"eps={eps}: 2(1+eps) is not exact in float32")
    return torch.tensor(f, dtype=dtype)


def peel(src: torch.Tensor, dst: torch.Tensor, n_nodes: int, eps: float, max_passes: int,
         precision: str = "float32") -> Tuple[Answer, List[Tuple[int, int]]]:
    """One lane of Algorithm 1 on ``src``'s device."""
    dt = PRECISIONS[precision]
    dev = src.device
    src = src.long()
    dst = dst.long()
    factor = _factor(eps, dt).to(dev)
    alive = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    best = alive
    best_rho = -math.inf
    best_size = 0
    work = []
    t = 0
    while t < max_passes:
        n = int(alive.sum())
        if n == 0:
            break
        ok = alive[src] & alive[dst]
        deg = (torch.bincount(src[ok], minlength=n_nodes)
               + torch.bincount(dst[ok], minlength=n_nodes))
        e = int(ok.sum())
        work.append((e, n))
        rho = torch.tensor(e, dtype=dt, device=dev) / torch.tensor(n, dtype=dt, device=dev)
        rho_v = float(rho)
        if rho_v > best_rho:
            best, best_rho, best_size = alive, rho_v, n
        thresh = factor * rho
        d = deg.to(dt)
        least = torch.where(alive, d, torch.inf).min()
        alive = alive & ~((d <= thresh) | (d <= least))
        t += 1
    nodes = torch.nonzero(best).flatten().cpu().numpy()
    return Answer(nodes=nodes, density=best_rho, size=best_size, passes=t), work


def replay(src: torch.Tensor, dst: torch.Tensor, n_nodes: int, eps: Sequence[float],
           max_passes: int, precision: str = "float32") -> Replay:
    """Every lane of a query (one eps a lane) on the same graph."""
    answers, work = [], []
    for e in eps:
        a, w = peel(src, dst, n_nodes, float(e), max_passes, precision)
        answers.append(a)
        work.append(w)
    return Replay(answers=answers, work=work)
