"""Synthetic graph generators (host-side numpy), as in ``repro.graph.generators``.

Each draws from ``numpy.random.default_rng(seed)`` in exactly the
reference's order, so both packages build byte-identical edge arrays from
the same arguments; only the last step puts them on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.edgelist import Device, EdgeList, dedup_edges, from_numpy


def erdos_renyi(
    n: int, avg_deg: float, seed: int = 0, directed: bool = False,
    *, device: Device = None,
) -> EdgeList:
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / (1 if directed else 2))
    src = rng.integers(0, n, size=2 * m + 16)
    dst = rng.integers(0, n, size=2 * m + 16)
    src, dst = dedup_edges(src, dst, directed=directed)
    src, dst = src[:m], dst[:m]
    return from_numpy(src, dst, n, directed=directed, device=device)


def planted_dense_subgraph(
    n: int,
    avg_deg: float,
    k: int,
    p_dense: float,
    seed: int = 0,
    *,
    device: Device = None,
) -> Tuple[EdgeList, np.ndarray]:
    """ER background + a planted dense block on the first ``k`` nodes.

    Returns the graph and the planted node-index array.
    """
    rng = np.random.default_rng(seed)
    m_bg = int(n * avg_deg / 2)
    src_bg = rng.integers(0, n, size=m_bg)
    dst_bg = rng.integers(0, n, size=m_bg)
    iu = np.triu_indices(k, 1)
    keep = rng.random(iu[0].shape[0]) < p_dense
    src = np.concatenate([src_bg, iu[0][keep]])
    dst = np.concatenate([dst_bg, iu[1][keep]])
    src, dst = dedup_edges(src, dst, directed=False)
    return from_numpy(src, dst, n, device=device), np.arange(k)


def chung_lu_power_law(
    n: int, exponent: float = 2.2, avg_deg: float = 8.0, seed: int = 0,
    *, device: Device = None,
) -> EdgeList:
    """Chung-Lu graph with power-law expected degrees; the hubs get the
    lowest ids, so the first node tile holds most endpoint slots."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1) ** (-1.0 / (exponent - 1.0))).astype(np.float64)
    w *= n * avg_deg / w.sum()
    p = w / w.sum()
    m = int(n * avg_deg / 2)
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    src, dst = dedup_edges(src, dst, directed=False)
    return from_numpy(src, dst, n, device=device)


def directed_planted(
    n: int, avg_deg: float, ks: int, kt: int, p_dense: float, seed: int = 0,
    *, device: Device = None,
) -> Tuple[EdgeList, np.ndarray, np.ndarray]:
    """Directed ER background + a planted dense S->T block (S = the first
    ``ks`` nodes, T = the next ``kt``).  Returns the graph, ``s_ids`` and
    ``t_ids``."""
    rng = np.random.default_rng(seed)
    m_bg = int(n * avg_deg)
    src_bg = rng.integers(0, n, size=m_bg)
    dst_bg = rng.integers(0, n, size=m_bg)
    s_ids = np.arange(ks)
    t_ids = np.arange(ks, ks + kt)
    grid_s, grid_t = np.meshgrid(s_ids, t_ids, indexing="ij")
    keep = rng.random(grid_s.size) < p_dense
    src = np.concatenate([src_bg, grid_s.ravel()[keep]])
    dst = np.concatenate([dst_bg, grid_t.ravel()[keep]])
    src, dst = dedup_edges(src, dst, directed=True)
    return from_numpy(src, dst, n, directed=True, device=device), s_ids, t_ids


def bipartite_spam(
    n_users: int,
    n_items: int,
    avg_deg: float,
    spam_users: int,
    spam_items: int,
    p_spam: float,
    seed: int = 0,
    *,
    device: Device = None,
) -> Tuple[EdgeList, np.ndarray, np.ndarray]:
    """User->item interaction graph with a planted spam block (the paper's
    link-spam application): nodes ``0..n_users-1`` are users, the next
    ``n_items`` items; the block is the last ``spam_users`` users and the
    last ``spam_items`` items.  Returns the graph and both id arrays."""
    rng = np.random.default_rng(seed)
    m_bg = int(n_users * avg_deg)
    src_bg = rng.integers(0, n_users, size=m_bg)
    dst_bg = rng.integers(0, n_items, size=m_bg) + n_users
    su = np.arange(n_users - spam_users, n_users)
    si = np.arange(n_items - spam_items, n_items) + n_users
    gs, gi = np.meshgrid(su, si, indexing="ij")
    keep = rng.random(gs.size) < p_spam
    src = np.concatenate([src_bg, gs.ravel()[keep]])
    dst = np.concatenate([dst_bg, gi.ravel()[keep]])
    src, dst = dedup_edges(src, dst, directed=True)
    n = n_users + n_items
    return from_numpy(src, dst, n, directed=True, device=device), su, si
