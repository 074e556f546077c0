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


def barabasi_albert(
    n: int, m_attach: int = 4, seed: int = 0, *, device: Device = None,
) -> EdgeList:
    """Preferential attachment: node ``v`` links to ``m_attach`` distinct
    endpoints drawn from the degree-weighted list of earlier endpoints."""
    rng = np.random.default_rng(seed)
    repeated: list[int] = list(range(m_attach))
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m_attach, n):
        chosen = rng.choice(np.asarray(repeated), size=m_attach, replace=False)
        for t in set(int(c) for c in chosen):
            src_l.append(v)
            dst_l.append(t)
            repeated.append(v)
            repeated.append(t)
    src, dst = dedup_edges(np.asarray(src_l), np.asarray(dst_l), directed=False)
    return from_numpy(src, dst, n, device=device)


def _regular_circulant(n: int, d: int, offset_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """A d-regular graph on n nodes (circulant; d=1 => perfect matching)."""
    assert d < n
    src_l = []
    dst_l = []
    if d == 1:
        assert n % 2 == 0
        a = np.arange(0, n, 2)
        src_l.append(a)
        dst_l.append(a + 1)
    else:
        assert d % 2 == 0 or n % 2 == 0
        half = d // 2
        a = np.arange(n)
        for j in range(1, half + 1):
            src_l.append(a)
            dst_l.append((a + j) % n)
        if d % 2 == 1:
            a2 = np.arange(n // 2)
            src_l.append(a2)
            dst_l.append((a2 + n // 2) % n)
    src = np.concatenate(src_l) + offset_nodes
    dst = np.concatenate(dst_l) + offset_nodes
    return src, dst


def lemma5_instance(k: int, *, device: Device = None) -> EdgeList:
    """The Lemma 5 pass-lower-bound instance: k disjoint subgraphs
    G_1..G_k, G_i 2^{i-1}-regular on 2^{2k+1-i} nodes, each with 2^{2k-1}
    edges.  Algorithm 1 needs Omega(k / log k) passes on it."""
    srcs, dsts = [], []
    offset = 0
    for i in range(1, k + 1):
        ni = 2 ** (2 * k + 1 - i)
        di = 2 ** (i - 1)
        s, d = _regular_circulant(ni, di, offset)
        srcs.append(s)
        dsts.append(d)
        offset += ni
    src, dst = dedup_edges(np.concatenate(srcs), np.concatenate(dsts), directed=False)
    return from_numpy(src, dst, offset, device=device)


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


def planted_partition(
    n: int, k: int, p_in, p_out: float, seed: int = 0, *, device: Device = None,
) -> Tuple[EdgeList, np.ndarray]:
    """k equal communities: edge probability ``p_in`` inside (a scalar or one
    per community; unequal densities make the peel extract them in order),
    ``p_out`` across.  Each block's edge count is one binomial draw, so a
    large n stays cheap.  Returns the graph and the labels ``int[n]``."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n // k + 1)[:n]
    p_in_list = [p_in] * k if np.isscalar(p_in) else list(p_in)
    srcs, dsts = [], []
    idx_of = [np.nonzero(labels == c)[0] for c in range(k)]
    for a in range(k):
        na = len(idx_of[a])
        m_in = rng.binomial(na * (na - 1) // 2, p_in_list[a])
        srcs.append(idx_of[a][rng.integers(0, na, m_in)])
        dsts.append(idx_of[a][rng.integers(0, na, m_in)])
        for b in range(a + 1, k):
            nb = len(idx_of[b])
            m_x = rng.binomial(na * nb, p_out)
            srcs.append(idx_of[a][rng.integers(0, na, m_x)])
            dsts.append(idx_of[b][rng.integers(0, nb, m_x)])
    src, dst = dedup_edges(np.concatenate(srcs), np.concatenate(dsts), directed=False)
    return from_numpy(src, dst, n, device=device), labels


def weighted_preferential(n: int, seed: int = 0, *, device: Device = None) -> EdgeList:
    """The deterministic weighted preferential-attachment graph of the
    Lemma 6 proof sketch: node u links to every earlier v with weight
    proportional to v's current weighted degree.  O(n^2) edges on the host;
    ``seed`` is unused, as in the reference."""
    deg = np.zeros(n, np.float64)
    srcs, dsts, ws = [], [], []
    deg[0] = deg[1] = 1.0
    srcs.append(0)
    dsts.append(1)
    ws.append(1.0)
    for u in range(2, n):
        w_uv = deg[:u] / deg[:u].sum()
        srcs.extend([u] * u)
        dsts.extend(range(u))
        ws.extend(w_uv.tolist())
        deg[:u] += w_uv
        deg[u] = w_uv.sum()
    return from_numpy(np.asarray(srcs), np.asarray(dsts), n,
                      weight=np.asarray(ws, np.float32), device=device)
