"""Turnstile runtime of the port: densest-subgraph maintenance over dynamic
graph streams (McGregor–Tench–Vorotnikova–Vu, arXiv 1506.04417);
counterpart of ``repro.core.turnstile``.

The graph arrives as batches of edge insertions and deletions, absorbed by
an update-linear ℓ0-sampling sketch (``kernels/l0_sampler``: the kernel K3
on the card).  A query recovers the sketch's uniform edge sample on the
host and peels only the sample through the port's ``Solver.solve``, its
density rescaled by the inverse sample rate.  MTVV Theorem 6 gives the
(1+eps)·(2+2eps) envelope against the true maximum density.

* :class:`TurnstileSketch` — the device-resident sketch and its update.
  ``apply()`` pads each batch into the reference's power-of-two buckets
  (floor ``TURNSTILE_BATCH_FLOOR``), so both packages see the same rows.
  The reference counts compilations in ``trace_count``; nothing compiles
  here, and ``kernels.l0_sampler.ops.l0_delta.launches`` counts the K3
  launches instead (one per applied batch on the card).
* :class:`TurnstileDensest` — recover, pad the sample into a pow2 edge
  bucket, ``Solver.solve`` it (``backend='pallas'`` runs K1 on the sample),
  rescale.  Query telemetry lands in ``extras['turnstile']``.

The stream must describe a SIMPLE undirected graph (see the reference);
:func:`repro_torch.graph.edgelist.apply_updates` is the exact host
reference for well-formed churn streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import constants, faults, hostsync
from repro_torch.core.api import DenseSubgraphResult, Problem, Solver, default_solver
from repro_torch.graph.edgelist import Device, EdgeList, resolve_device
from repro_torch.graph.partition import pow2_bucket
from repro_torch.kernels import hashing
from repro_torch.kernels.l0_sampler.ops import L0Params, add_wrapped, l0_update, make_l0_params

__all__ = ["TurnstileDensest", "TurnstileSketch", "sample_edgelist"]

_SAMPLE_EDGE_FLOOR = constants.TURNSTILE_SAMPLE_EDGE_FLOOR
_SAMPLE_NODE_FLOOR = constants.TURNSTILE_SAMPLE_NODE_FLOOR
_BATCH_FLOOR = constants.TURNSTILE_BATCH_FLOOR
# Decode-round runaway guard (real decodes finish in O(log k) rounds).
_MAX_DECODE_ROUNDS = 256


# -- numpy mirrors of the hash family ---------------------------------------
# The host decoder re-hashes recovery candidates; numpy uint32 arithmetic
# wraps mod 2^32, so these are the same bits as kernels/hashing.py and
# csrc/hashing.cuh (the recover-vs-insert tests pin it).


def _np_mix32_pair(a_x, a_y, c, x, y):
    x = x.astype(np.uint32)
    y = y.astype(np.uint32)
    a_x = np.asarray(a_x, np.uint32)  # scalar or per-element multiplier
    a_y = np.asarray(a_y, np.uint32)
    c = np.asarray(c, np.uint32)
    with np.errstate(over="ignore"):
        h = a_x * x + a_y * y + c
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(hashing.AVALANCHE)
        h = h ^ (h >> np.uint32(15))
    return h


def _np_edge_cells(p: L0Params, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.stack([
        (_np_mix32_pair(p.a_cell[j, 0], p.a_cell[j, 1], p.c_cell[j], u, v)
         % np.uint32(p.n_cells)).astype(np.int32)
        for j in range(p.n_tables)
    ])


def _np_edge_fingerprint(p: L0Params, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return _np_mix32_pair(p.a_fp[0], p.a_fp[1], p.c_fp[0], u, v).view(np.int32)


def _np_edge_level(p: L0Params, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h = _np_mix32_pair(p.a_lvl[0], p.a_lvl[1], p.c_lvl[0], u, v)
    # min(L-1, 32 - bit_length(h)); uint32 is exact in float64, so
    # floor(log2) is the high-bit position, and h == 0 clamps to L-1.
    bits = np.zeros(h.shape, np.int64)
    nz = h > 0
    bits[nz] = np.floor(np.log2(h[nz].astype(np.float64))).astype(np.int64) + 1
    return np.minimum(p.n_levels - 1, 32 - bits).astype(np.int32)


EdgeBatch = Union[np.ndarray, torch.Tensor, Tuple, None]


def _as_edge_arrays(edges: EdgeBatch, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (k, 2) array or a (src, dst) pair, numpy or torch, as two int32
    tensors on ``device`` (tensors already there are not copied)."""
    if edges is None:
        z = torch.zeros(0, dtype=torch.int32, device=device)
        return z, z
    if isinstance(edges, tuple) and len(edges) == 2:
        src, dst = edges
    else:
        arr = edges if isinstance(edges, torch.Tensor) else np.asarray(edges)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(
                f"edge batch must be a (k, 2) array or a (src, dst) pair, "
                f"got shape {tuple(arr.shape)}"
            )
        src, dst = arr[:, 0], arr[:, 1]

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.int32).contiguous()
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return t(src), t(dst)


class TurnstileSketch:
    """Device-resident ℓ0-sampling sketch of a dynamic edge SET.

    State is one int32 tensor ``[n_levels, n_tables, n_cells, 4]`` on
    ``device`` (default: the card).  :meth:`apply` absorbs a batch of
    insertions and deletions (K3 adds into the state in place on the
    card), :meth:`recover` decodes the current uniform edge sample on the
    host.  Updates are linear: merged sketches equal the sketch of the
    union, updates commute, and an insert then a delete restores zeros.
    """

    def __init__(
        self,
        n_nodes: int,
        sample_edges: int = 1 << 14,
        *,
        n_levels: int = 32,
        n_tables: int = 3,
        seed: int = 0,
        batch_floor: int = _BATCH_FLOOR,
        device: Device = None,
    ):
        if sample_edges < 1:
            raise ValueError(f"sample_edges={sample_edges} must be >= 1")
        if n_levels < 1:
            raise ValueError(f"n_levels={n_levels} must be >= 1")
        self.n_nodes = int(n_nodes)
        self.sample_edges = int(sample_edges)
        self.seed = int(seed)
        self.device = resolve_device(device)
        # C = pow2(sample_edges) cells per table: the decoder commits only to
        # a level holding <= sample_edges edges, so d=3 tables run at load
        # <= 1/3, inside the IBLT peeling threshold.
        n_cells = pow2_bucket(self.sample_edges, _SAMPLE_EDGE_FLOOR)
        self.params: L0Params = make_l0_params(
            n_levels=n_levels, n_cells=n_cells, n_tables=n_tables, seed=seed
        )
        self.tables = torch.zeros(
            (n_levels, n_tables, n_cells, 4), dtype=torch.int32, device=self.device
        )
        self.batch_floor = int(batch_floor)
        self.batches_applied = 0
        self.updates_applied = 0
        self.recovery_failures = 0
        self.recovery_escalations = 0  # recoveries that succeeded above l*

    # -- updates ------------------------------------------------------------
    def apply(self, insert_edges: EdgeBatch = None,
              delete_edges: EdgeBatch = None) -> "TurnstileSketch":
        """Absorbs one batched turnstile update (±edges) into the sketch.

        Edges may be numpy arrays or tensors (tensors on the sketch's
        device are used where they lie).  The batch is padded with sign-0
        rows to a power-of-two bucket (floor ``batch_floor``), as in the
        reference.  A batch must not hold the same edge on both sides.
        """
        ins_u, ins_v = _as_edge_arrays(insert_edges, self.device)
        del_u, del_v = _as_edge_arrays(delete_edges, self.device)
        n_ins, n_del = ins_u.shape[0], del_u.shape[0]
        k = n_ins + n_del
        if k == 0:
            return self
        rows = pow2_bucket(k, self.batch_floor)
        u = torch.zeros(rows, dtype=torch.int32, device=self.device)
        v = torch.zeros(rows, dtype=torch.int32, device=self.device)
        s = torch.zeros(rows, dtype=torch.int32, device=self.device)
        u[:n_ins], u[n_ins:k] = ins_u, del_u
        v[:n_ins], v[n_ins:k] = ins_v, del_v
        s[:n_ins], s[n_ins:k] = 1, -1  # sign 0 below: padding rows vanish
        l0_update(self.tables, u, v, s, self.params)
        self.batches_applied += 1
        self.updates_applied += k
        return self

    def merge(self, other: "TurnstileSketch") -> "TurnstileSketch":
        """Folds another sketch of the SAME geometry and seed into this one
        (the sketch of the summed update streams)."""
        if not isinstance(other, TurnstileSketch):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if (
            self.tables.shape != other.tables.shape
            or self.seed != other.seed
            or self.n_nodes != other.n_nodes
        ):
            raise ValueError(
                "mergeable sketches need identical geometry "
                f"(shape, seed, n_nodes): {tuple(self.tables.shape)}/{self.seed} vs "
                f"{tuple(other.tables.shape)}/{other.seed}"
            )
        self.tables = add_wrapped(self.tables, other.tables.to(self.device))
        self.batches_applied += other.batches_applied
        self.updates_applied += other.updates_applied
        return self

    # -- recovery -----------------------------------------------------------
    def level_counts(self) -> np.ndarray:
        """int64[L] EXACT number of live edges per level: any one table's
        count column sums to it (the count field is linear).  Reduced on
        the device; the host reads L numbers."""
        return np.asarray(hostsync.read(self.tables[:, 0, :, 0].sum(1)), np.int64)

    def _aggregate(self, level: int) -> np.ndarray:
        """int32[d, C, 4]: the tables of levels >= ``level`` summed mod 2^32
        on the device (the sketch of the Bernoulli(2^-level) sample)."""
        return hostsync.fetch(hashing.to_i32(self.tables[level:].sum(0, dtype=torch.int64)))

    def recover(self, target: Optional[int] = None) -> Tuple[np.ndarray, int, Dict[str, Any]]:
        """Decodes the current uniform edge sample, as the reference does:
        the smallest level ``l*`` whose suffix holds at most ``target``
        edges (an exact count), then IBLT peeling of the suffix-summed
        tables; a level that does not fully decode counts a recovery
        failure and the next level is tried.  Never returns a false edge.

        Returns ``(edges int32[k, 2] sorted by (u, v), level, info)``.
        """
        tau = self.sample_edges if target is None else int(target)
        L = self.tables.shape[0]
        counts = self.level_counts()
        suffix = counts[::-1].cumsum()[::-1]
        l_star = int(np.argmax(suffix <= tau)) if (suffix <= tau).any() else L
        failures0 = self.recovery_failures
        for level in range(l_star, L):
            agg = self._aggregate(level)
            try:
                # A fired fault is a decode failure: the real escalation path.
                faults.fire("turnstile.decode", key=level)
                decoded = self._decode(agg, level)
            except faults.InjectedFault:
                decoded = None
            if decoded is not None:
                edges, rounds = decoded
                if level > l_star:
                    self.recovery_escalations += 1
                info = {
                    "level": level,
                    "first_level_tried": l_star,
                    "sample_rate": 2.0 ** (-level),
                    "sample_edges_recovered": int(len(edges)),
                    "recovery_failures": self.recovery_failures - failures0,
                    "decode_rounds": rounds,
                    "exact": level == 0,
                    "level_suffix_count": int(suffix[level]),
                }
                return edges, level, info
            self.recovery_failures += 1
        raise RuntimeError(
            f"l0 recovery failed at every level >= {l_star} "
            f"(suffix counts {suffix[min(l_star, L - 1):].tolist()}; "
            "was the same live edge inserted twice, or a non-live edge "
            "deleted?)"
        )

    def _decode(self, agg: np.ndarray, level: int) -> Optional[Tuple[np.ndarray, int]]:
        """IBLT peeling of one aggregated [d, C, 4] table set (host numpy,
        the reference's decoder).  Returns ``(edges sorted by (u, v),
        rounds)`` on full decode (all cells back to zero), else None."""
        p = self.params
        d, C = p.n_tables, p.n_cells
        work = agg.copy()
        n = self.n_nodes
        seen_keys = np.zeros(0, np.int64)
        out_u: list = []
        out_v: list = []
        rounds = 0
        # Round 1 scans every cell; later rounds re-examine only the cells
        # the previous round's subtractions touched.
        cand = np.nonzero(work[:, :, 0] == 1)  # (table, cell) singletons
        for rounds in range(1, _MAX_DECODE_ROUNDS + 1):
            if len(cand[0]) == 0:
                break
            got = work[cand[0], cand[1]]  # [k, 4]
            u, v, fp = got[:, 1], got[:, 2], got[:, 3]
            ok = (u >= 0) & (v > u) & (v < n)
            uu = np.where(ok, u, 0).astype(np.int32)
            vv = np.where(ok, v, 1).astype(np.int32)
            # A true singleton re-hashes consistently: fingerprint, its own
            # cell in the table it was found in, and a level >= the floor.
            ok &= _np_edge_fingerprint(p, uu, vv) == fp
            own = _np_mix32_pair(
                p.a_cell[cand[0], 0], p.a_cell[cand[0], 1], p.c_cell[cand[0]], uu, vv
            )
            ok &= (own % np.uint32(C)).astype(np.int64) == cand[1]
            ok &= _np_edge_level(p, uu, vv) >= level
            if not ok.any():
                break
            # Dedup (the same edge peels as a singleton in several tables).
            key = u[ok].astype(np.int64) * n + v[ok]
            _, first = np.unique(key, return_index=True)
            eu = u[ok][first].astype(np.int32)
            ev = v[ok][first].astype(np.int32)
            fresh = (
                ~np.isin(key[first], seen_keys)
                if seen_keys.size
                else np.ones(len(first), bool)
            )
            if not fresh.any():
                break
            eu, ev = eu[fresh], ev[fresh]
            seen_keys = np.concatenate([seen_keys, key[first][fresh]])
            # Subtract the recovered edges from all their cells (mod 2^32):
            # a per-field bincount, exact in float64, then re-wrapped.
            ecells = _np_edge_cells(p, eu, ev)  # [d, k]
            efp = _np_edge_fingerprint(p, eu, ev)
            vals = np.stack(
                [np.ones(len(eu), np.int32), eu, ev, efp], axis=-1
            ).astype(np.float64).reshape(-1)  # [k*4] field-interleaved
            for j in range(d):
                flat_idx = (ecells[j][:, None] * 4 + np.arange(4)).reshape(-1)
                acc = np.bincount(
                    flat_idx, weights=vals, minlength=C * 4
                ).astype(np.int64).reshape(C, 4)
                diff = work[j].astype(np.int64) - acc
                work[j] = (diff & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
            out_u.append(eu)
            out_v.append(ev)
            flat = np.unique(
                np.repeat(np.arange(d), ecells.shape[1]) * C + ecells.reshape(-1)
            )
            tj, cj = flat // C, flat % C
            hit = work[tj, cj, 0] == 1
            cand = (tj[hit], cj[hit])
        if not np.all(work == 0):
            return None
        if out_u:
            eu = np.concatenate(out_u)
            ev = np.concatenate(out_v)
        else:
            eu = np.zeros(0, np.int32)
            ev = np.zeros(0, np.int32)
        order = np.lexsort((ev, eu))
        return np.stack([eu[order], ev[order]], axis=1), rounds


def sample_edgelist(
    edges: np.ndarray, n_nodes: int, device: Device = None
) -> Tuple[EdgeList, Optional[np.ndarray]]:
    """A recovered sample (int32 ``[k, 2]``, u < v) as the padded
    insert-mode graph that :meth:`TurnstileDensest.query` peels.

    The sample is relabeled onto its touched nodes when that shrinks the
    node space (pow2 node bucket, floor ``TURNSTILE_SAMPLE_NODE_FLOOR``)
    and padded into a pow2 edge bucket (floor
    ``TURNSTILE_SAMPLE_EDGE_FLOOR``) with masked, zero-weight rows.
    Returns the EdgeList and the sorted original ids of the compact ids,
    or ``None`` where the sample keeps the original ids.
    """
    k = len(edges)
    e_src = edges[:, 0] if k else np.zeros(0, np.int32)
    e_dst = edges[:, 1] if k else np.zeros(0, np.int32)
    nodes = np.unique(edges) if k else np.zeros(0, np.int32)
    n_peel = pow2_bucket(max(len(nodes), 1), _SAMPLE_NODE_FLOOR)
    if n_peel < n_nodes:
        e_src = np.searchsorted(nodes, e_src).astype(np.int32)
        e_dst = np.searchsorted(nodes, e_dst).astype(np.int32)
    else:
        n_peel, nodes = n_nodes, None
    m_pad = pow2_bucket(max(k, 1), _SAMPLE_EDGE_FLOOR)
    src = np.zeros(m_pad, np.int32)
    dst = np.zeros(m_pad, np.int32)
    msk = np.zeros(m_pad, bool)
    src[:k] = e_src
    dst[:k] = e_dst
    msk[:k] = True
    dev = resolve_device(device)
    sample = EdgeList(
        src=torch.from_numpy(src).to(dev),
        dst=torch.from_numpy(dst).to(dev),
        weight=torch.from_numpy(msk.astype(np.float32)).to(dev),
        mask=torch.from_numpy(msk).to(dev),
        n_nodes=n_peel,
        directed=False,
    )
    return sample, nodes


class TurnstileDensest:
    """Continuous densest-subgraph maintenance: a :class:`TurnstileSketch`
    feeding the port's peel engine.

    ``problem`` must resolve to ``stream_mode='turnstile'``; its
    ``sample_edges``/``sketch_seed`` configure the sketch, and its eps,
    max_passes, track_history and exact-vs-pallas backend configure the
    sample peel.  ``query()`` returns a :class:`DenseSubgraphResult` whose
    densities are rescaled by the inverse sample rate, with the recovery
    telemetry in ``extras['turnstile']``.
    """

    def __init__(
        self,
        n_nodes: int,
        problem: Optional[Problem] = None,
        *,
        solver: Optional[Solver] = None,
        n_levels: int = 32,
        n_tables: int = 3,
        batch_floor: int = _BATCH_FLOOR,
        device: Device = None,
    ):
        if problem is None:
            problem = Problem.undirected(stream_mode="turnstile")
        prob = problem.resolve(n_nodes)
        if prob.stream_mode != "turnstile":
            raise ValueError(
                f"TurnstileDensest needs Problem(stream_mode='turnstile'), "
                f"got stream_mode={problem.stream_mode!r}"
            )
        self.n_nodes = int(n_nodes)
        self.problem = prob
        self.solver = solver if solver is not None else default_solver
        self.sketch = TurnstileSketch(
            n_nodes,
            prob.sample_edges,
            n_levels=n_levels,
            n_tables=n_tables,
            seed=prob.sketch_seed,
            batch_floor=batch_floor,
            device=device,
        )

    def apply(self, insert_edges: EdgeBatch = None,
              delete_edges: EdgeBatch = None) -> "TurnstileDensest":
        """Absorbs one ±edge batch (see :meth:`TurnstileSketch.apply`); K3
        loads through the solver's cache of built kernels."""
        with self.solver.kernel_cache(self.problem):
            self.sketch.apply(insert_edges, delete_edges)
        return self

    def query(self) -> DenseSubgraphResult:
        """Current (1+eps)·(2+2eps)-approximate densest subgraph.

        Recovers the sample, relabels it onto its touched nodes when that
        shrinks the node space (``extras['turnstile']['sample_nodes']``
        then maps compact ids back), pads it into a pow2 edge bucket, and
        solves it as an ordinary insert-mode problem, ladder off, on the
        sketch's device; ``best_density``/``history_m``/``history_rho``
        come back multiplied by ``2^level``.  ``level == 0`` means exact.
        """
        edges, level, info = self.sketch.recover()
        dev = self.sketch.device
        sample, nodes = sample_edgelist(edges, self.n_nodes, dev)
        inner = dataclasses.replace(
            self.problem, stream_mode="insert", compaction="off", substrate="jit"
        )
        res = self.solver.solve(sample, inner)
        scale = float(2**level)
        info = dict(info)
        info["updates_applied"] = self.sketch.updates_applied
        info["batches_applied"] = self.sketch.batches_applied
        info["sample_padded_edges"] = sample.n_edges_padded
        info["sample_n_nodes"] = sample.n_nodes
        if nodes is not None:
            info["sample_nodes"] = nodes
        extras = dict(res.extras or {})
        extras["turnstile"] = info
        prov = res.provenance
        if prov is not None:
            prov = dataclasses.replace(prov, substrate="turnstile")
        hist_scale = torch.tensor(scale, dtype=torch.float32, device=dev)
        return dataclasses.replace(
            res,
            best_density=res.best_density * hist_scale,
            history_m=res.history_m * hist_scale,
            history_rho=res.history_rho * hist_scale,
            extras=extras,
            provenance=prov,
        )
