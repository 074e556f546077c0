"""Semi-streaming driver for Algorithm 1, the paper's streaming model
(counterpart of ``repro.core.streaming``).

The edge list lives outside device memory (numpy arrays, memmaps or any
chunk iterator); only O(n) node state is held on the device: the alive
bitmap, the degree vector, the full-space alive and best sets.  Each pass
streams the edges chunk by chunk through a bounded async pipeline: at most
``prefetch`` chunks are resident on the host, worker threads copy chunks to
the device and count their degrees, and the chunks are reduced strictly in
stream order, so the result is the reference's bit for bit on unit weights.

On the card each worker holds a staging slot: its own CUDA stream and
pinned host buffers.  A chunk is copied into the slot's pinned buffers and
moved with ``non_blocking=True``; its degrees are counted on the slot's
stream (the engine's :func:`~repro_torch.core.engine.segment_degree_count`,
``index_add_``); an event marks the chunk done.  The reduce stream (the
caller's current stream) waits on that event and adds the chunk's partial
degree vector in f32 and its total in f64, in stream order, exactly as the
reference adds them on the host.  The hazards and what handles them:

* the alive bitmap a pass reads is written on the reduce stream by the
  previous pass's step: every chunk's stream waits on an event recorded
  after it, and ``record_stream`` keeps its memory from reuse while a
  chunk's stream may still read it;
* a chunk's outputs are made on its slot's stream and read on the reduce
  stream: ``record_stream`` before the reference drops;
* a pinned buffer is refilled only after the event of its last copy;
* a speculative duplicate writes its own outputs; only the first success
  is reduced;
* CUDA errors are asynchronous, so a chunk attempt fails only through
  host-side errors (the chunk stream's own, ``faults.fire``, a malformed
  chunk), which keeps the retry path the reference's.

Nothing n-sized comes back per chunk and no per-chunk scalar is read: a
pass makes one host read (rho, the new alive count and the alive edge
count, through :func:`repro_torch.hostsync.read`); the full-space bitmaps
come back only for a checkpoint write (deferred into the next pass's
window), a rung rebuild and the end of the run.

The fault-tolerance layer is the reference's: per-pass atomic checkpoints
of the O(n) state (the same ``stream_state.npz``), speculative re-issue of
the straggler tail, exception safety (a failing chunk re-raises its real
error; a failing pass never loses the previous checkpoint), and the
geometric ladder's out-of-core spill (the same rung directories and
manifests), so either package resumes what the other wrote.
"""

from __future__ import annotations

import collections
import os
import queue
import shutil
import threading
import time
import warnings
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import constants, faults, hostsync
from repro_torch.core.density import max_passes_bound
from repro_torch.core.engine import segment_degree_count, undirected_pass_step
from repro_torch.graph.edgelist import (
    Device,
    EdgeSpillWriter,
    open_edge_spill,
    open_edges_memmap,
    resolve_device,
)
from repro_torch.graph.partition import pow2_bucket
from repro_torch.ioutil import atomic_write_file

Chunk = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (src, dst, weight)

# Rolling bound on the per-chunk timing record.
_TIMINGS_WINDOW = 4096
# How many times a FAILED chunk (no success yet, no duplicate in flight) is
# re-issued before its error surfaces (separate from straggler speculation).
_MAX_FAILURE_RETRIES = 1
# Dtypes of a staged chunk: the device sees int32 ids and f32 weights.
_STAGE_DTYPES = (torch.int32, torch.int32, torch.float32)


def _chunk_stats(src, dst, w, alive):
    """Partial (degree vector, f32 total weight, int32 alive edge count) of
    one edge chunk, on ``alive``'s device.  The count is the engine's
    :func:`~repro_torch.core.engine.segment_degree_count`, accumulated in
    f32 whatever the weight dtype."""
    # index_select takes the int32 ids as they are (advanced indexing
    # would cast each chunk's ids to int64 first).
    ok = alive.index_select(0, src) & alive.index_select(0, dst)
    w_alive = torch.where(ok, w.to(torch.float32), 0.0)
    deg, total = segment_degree_count(src, dst, w_alive, alive.shape[0])
    return deg, total, ok.sum(dtype=torch.int32)


def _host_chunk(chunk: Chunk, out=None):
    """The chunk's arrays cast to the staged dtypes (into ``out`` when
    given).  ``same_kind`` casting: a malformed chunk (an object array, a
    complex weight) raises TypeError here, before any device work."""
    n = len(chunk[0])
    if any(len(a) != n for a in chunk):
        raise ValueError("chunk arrays must have equal length")
    if out is None:
        out = [torch.empty(n, dtype=dt).numpy() for dt in _STAGE_DTYPES]
    for o, a in zip(out, chunk):
        np.copyto(o, a, casting="same_kind")
    return out


class _Slot:
    """A worker's staging on the card: its stream and pinned host buffers
    (grown to the largest chunk seen), refilled only after ``copied``, the
    event of their last host-to-device copy."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.bufs = []
        self.copied: Optional[torch.cuda.Event] = None

    def buffers(self, n: int):
        if not self.bufs or self.bufs[0].numel() < n:
            self.bufs = [torch.empty(n, dtype=dt, pin_memory=True) for dt in _STAGE_DTYPES]
        return [b[:n] for b in self.bufs]


class _Deferred:
    """Exactly-once wrapper for a pass's deferred finalization (runs inside
    the next pass's pipeline window or at loop exit)."""

    def __init__(self, fn: Callable[[], None]):
        self._fn = fn
        self._ran = False

    def __call__(self) -> None:
        if not self._ran:
            self._ran = True
            self._fn()


@dataclass
class StreamState:
    alive: np.ndarray
    best_alive: np.ndarray
    best_rho: float
    pass_idx: int
    history: list = field(default_factory=list)  # (n_alive, e_alive, rho)


class StreamingDensest:
    """Multi-pass semi-streaming Algorithm 1 with checkpoint/restart, its
    node state on ``device`` (default: the card; ``'cpu'`` when asked).

    ``prefetch`` bounds the chunks resident in host memory during a pass
    (the pipeline's window); ``spill_dir`` sends the geometric ladder's
    rebuilt streams to disk-backed memmaps; ``residency_cap_edges`` is an
    optional hard bound on the edges the driver may hold in host RAM:
    exceeding it without a ``spill_dir`` raises.

    Observability, as in the reference: ``chunk_timings`` (a window of
    4096 host-side attempt times), ``speculative_reissues``,
    ``compactions``, ``spill_rungs``, ``peak_resident_chunks``,
    ``peak_resident_edges``; and ``bytes_to_device``, the chunk bytes
    copied to the card (0 on the CPU).
    """

    def __init__(
        self,
        chunk_stream: Callable[[], Iterator[Chunk]],
        n_nodes: int,
        eps: float = 0.5,
        checkpoint_dir: Optional[str] = None,
        n_workers: int = 4,
        speculative: bool = True,
        speculate_tail_frac: float = 0.2,
        compaction: str = "off",
        prefetch: int = 8,
        spill_dir: Optional[str] = None,
        residency_cap_edges: Optional[int] = None,
        device: Device = None,
    ):
        if compaction not in ("off", "geometric"):
            raise ValueError(f"compaction={compaction!r} not in ('off', 'geometric')")
        if prefetch < 1:
            raise ValueError(f"prefetch={prefetch} must be >= 1")
        if spill_dir is not None and compaction != "geometric":
            raise ValueError(
                "spill_dir is the geometric ladder's disk spill; this "
                "driver needs compaction='geometric' to use it"
            )
        self.chunk_stream = chunk_stream
        self.n_nodes = n_nodes
        self.eps = eps
        self.checkpoint_dir = checkpoint_dir
        self.n_workers = n_workers
        self.speculative = speculative
        self.speculate_tail_frac = speculate_tail_frac
        self.compaction = compaction
        self.prefetch = prefetch
        self.spill_dir = spill_dir
        self.residency_cap_edges = residency_cap_edges
        self.device = resolve_device(device)
        self.chunk_timings: collections.deque = collections.deque(maxlen=_TIMINGS_WINDOW)
        self.speculative_reissues = 0
        self.compactions = 0  # geometric: stream rebuilds performed
        self.spill_rungs = 0  # geometric: rebuilds that went to disk
        self.peak_resident_chunks = 0  # max chunks materialized at once
        self.peak_resident_edges = 0  # max edge slots in host RAM at once
        self.bytes_to_device = 0
        # Edge slots pinned in host RAM by an in-RAM rebuilt stream (0 for
        # the caller's stream and for spilled rebuilds).
        self._stream_resident_edges = 0
        self._cur_rung_dir: Optional[str] = None
        self._slots: Optional[queue.SimpleQueue] = None

    # ----- checkpointing -------------------------------------------------
    def _ckpt_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, "stream_state.npz")

    def _save(self, st: StreamState) -> None:
        """Atomic checkpoint write (:func:`repro_torch.ioutil.atomic_write_file`):
        a crash leaves the old checkpoint or the new one, never a torn one."""
        path = self._ckpt_path()
        if path is None:
            return
        faults.fire("streaming.checkpoint_save")
        atomic_write_file(
            path,
            lambda f: np.savez(
                f,
                alive=st.alive,
                best_alive=st.best_alive,
                best_rho=np.float64(st.best_rho),
                pass_idx=np.int64(st.pass_idx),
                history=np.asarray(st.history, np.float64).reshape(-1, 3),
            ),
            suffix=".npz.tmp",
        )

    def _load(self) -> Optional[StreamState]:
        """Fail-open checkpoint read: an unreadable checkpoint warns, is
        quarantined with one atomic rename to ``<path>.corrupt`` and the
        run starts fresh."""
        path = self._ckpt_path()
        if path is None or not os.path.exists(path):
            return None
        try:
            faults.fire("streaming.checkpoint_load")
            z = np.load(path)
            return StreamState(
                alive=z["alive"],
                best_alive=z["best_alive"],
                best_rho=float(z["best_rho"]),
                pass_idx=int(z["pass_idx"]),
                history=[tuple(r) for r in z["history"]],
            )
        except Exception as e:  # noqa: BLE001 — quarantine + start fresh
            quarantine = path + ".corrupt"
            # repro: allow(fault-sites) recovery path of the hooked streaming.checkpoint_load try above
            try:
                # repro: allow(atomic-io) quarantine rename of a corrupt file, not an artifact publish
                os.replace(path, quarantine)
            except OSError:
                quarantine = "<rename failed>"
            warnings.warn(
                f"checkpoint {path} is unreadable ({type(e).__name__}: {e}); "
                f"quarantined to {quarantine}, starting fresh",
                RuntimeWarning,
                stacklevel=2,
            )
            return None

    # ----- one chunk on the device ----------------------------------------
    def _stage_and_count(self, chunk: Chunk, alive: torch.Tensor, alive_ready):
        """One attempt at one chunk: ``(deg, total, count, done_event)``.
        On the card the chunk goes through a staging slot (module
        docstring); on the CPU it is counted in place (``done_event``
        None)."""
        if self.device.type != "cuda":
            s, d, w = (torch.from_numpy(a) for a in _host_chunk(chunk))
            return (*_chunk_stats(s, d, w, alive), None)
        slot = self._slots.get()
        try:
            if slot.copied is not None:
                slot.copied.synchronize()  # the buffers' last copy is done
            bufs = slot.buffers(len(chunk[0]))
            _host_chunk(chunk, [b.numpy() for b in bufs])
            with torch.cuda.stream(slot.stream):
                slot.stream.wait_event(alive_ready)
                alive.record_stream(slot.stream)
                s, d, w = (b.to(self.device, non_blocking=True) for b in bufs)
                slot.copied = torch.cuda.Event()
                slot.copied.record(slot.stream)
                out = _chunk_stats(s, d, w, alive)
                done = torch.cuda.Event()
                done.record(slot.stream)
            return (*out, done)
        finally:
            self._slots.put(slot)

    # ----- one streaming pass --------------------------------------------
    def _pass_stats(
        self,
        alive: torch.Tensor,
        stream: Optional[Callable[[], Iterator[Chunk]]] = None,
        prelude: Optional[Callable[[], None]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Streams all chunks once through the bounded async pipeline;
        returns (degree vector f32, total weight f64, alive edge count
        int64, edge slots streamed): device tensors, reduced in stream
        order on the caller's stream, and a host int.

        At most ``prefetch`` chunks are materialized at any moment; chunks
        are pulled lazily, dispatched to the worker pool and reduced in
        stream order as the reduce frontier advances, so the result is the
        same for every ``prefetch``/``n_workers`` setting and completion
        order.  ``prelude`` (the previous pass's deferred finalization)
        runs right after the first window is dispatched, and runs even if
        the pass fails.

        Failure semantics (the reference's): a chunk worker's exception is
        re-raised with its real traceback; speculative duplicates stay
        first-success-wins; with ``speculative`` on, a failed chunk with no
        live duplicate is retried once before the error surfaces.
        """
        cuda = self.device.type == "cuda"
        n = alive.shape[0]
        alive_ready = None
        if cuda:
            if self._slots is None:
                self._slots = queue.SimpleQueue()
                for _ in range(max(int(self.n_workers), 1)):
                    self._slots.put(_Slot(self.device))
            alive_ready = torch.cuda.Event()
            alive_ready.record(torch.cuda.current_stream(self.device))
        window = max(int(self.prefetch), 1)
        it = iter((stream or self.chunk_stream)())
        deg = torch.zeros(n, dtype=torch.float32, device=self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        n_ok = torch.zeros((), dtype=torch.int64, device=self.device)
        n_slots = 0
        resident: Dict[int, Chunk] = {}  # materialized, not yet reduced
        done: Dict[int, tuple] = {}
        inflight: Dict[int, int] = {}
        retries: Dict[int, int] = {}  # failure-triggered re-issues only
        reduced = 0  # the in-order reduce frontier
        resident_edges = 0
        n_seen = 0
        exhausted = False
        speculated = False
        lock = threading.Lock()

        def work(idx: int, chunk: Chunk) -> int:
            t0 = time.perf_counter()
            # Chaos hook: every attempt of a chunk (first issue, speculative
            # duplicate, retry) is one hit, keyed by the chunk index.
            faults.fire("streaming.chunk", key=idx)
            out = self._stage_and_count(chunk, alive, alive_ready)
            with lock:
                # First completion wins; a late duplicate of an already
                # reduced chunk must not re-enter ``done``.
                if idx not in done and idx in resident:
                    done[idx] = out
                self.chunk_timings.append(time.perf_counter() - t0)
                if cuda:
                    self.bytes_to_device += len(chunk[0]) * 12
            return idx

        prelude_ran = prelude is None
        try:
            with ThreadPoolExecutor(max_workers=self.n_workers) as ex:
                pending: Set[Future] = set()
                futmap: Dict[Future, int] = {}

                def submit(idx: int) -> None:
                    inflight[idx] = inflight.get(idx, 0) + 1
                    fut = ex.submit(work, idx, resident[idx])
                    futmap[fut] = idx
                    pending.add(fut)

                def fill() -> None:
                    nonlocal exhausted, n_seen, n_slots, resident_edges
                    while not exhausted and len(resident) < window:
                        try:
                            chunk = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        idx = n_seen
                        n_seen += 1
                        n_slots += len(chunk[0])
                        with lock:
                            resident[idx] = chunk
                            resident_edges += len(chunk[0])
                        self.peak_resident_chunks = max(self.peak_resident_chunks, len(resident))
                        self.peak_resident_edges = max(
                            self.peak_resident_edges,
                            resident_edges + self._stream_resident_edges,
                        )
                        submit(idx)

                fill()
                if prelude is not None:
                    prelude()
                    prelude_ran = True
                while pending:
                    fin, not_done = wait(pending, return_when=FIRST_COMPLETED)
                    pending = not_done
                    for fut in fin:
                        idx = futmap.pop(fut)
                        err = fut.exception()
                        with lock:
                            inflight[idx] -= 1
                            succeeded = idx in done or idx < reduced
                            live_dup = inflight[idx] > 0
                        if err is not None and not succeeded and not live_dup:
                            if (
                                self.speculative
                                and retries.get(idx, 0) < _MAX_FAILURE_RETRIES
                                and idx in resident
                            ):
                                retries[idx] = retries.get(idx, 0) + 1
                                self.speculative_reissues += 1
                                submit(idx)
                            else:
                                raise err  # the chunk's REAL error
                        if not inflight[idx] and (succeeded or err is None):
                            inflight.pop(idx, None)  # bounded bookkeeping
                            retries.pop(idx, None)
                    # Advance the in-order reduce frontier and refill the
                    # window.  The adds are queued on the reduce stream
                    # behind each chunk's done event: no host wait.
                    ready = []
                    with lock:
                        while reduced in done:
                            ready.append(done.pop(reduced))
                            chunk = resident.pop(reduced)
                            resident_edges -= len(chunk[0])
                            reduced += 1
                    for dd, tt, cc, ev in ready:
                        if ev is not None:
                            main = torch.cuda.current_stream(self.device)
                            main.wait_event(ev)
                        deg.add_(dd)
                        total.add_(tt)  # f64, as the reference's Python float
                        n_ok.add_(cc)
                        if ev is not None:
                            for t in (dd, tt, cc):
                                t.record_stream(main)
                    fill()
                    # Back-up tasks for the straggler tail (one round).
                    if (
                        self.speculative
                        and not speculated
                        and exhausted
                        and pending
                        and reduced + len(done) >= (1 - self.speculate_tail_frac) * n_seen
                    ):
                        for idx in list(resident):
                            if idx not in done and inflight.get(idx, 0) > 0:
                                self.speculative_reissues += 1
                                submit(idx)
                        speculated = True
        finally:
            if not prelude_ran:
                prelude()
        return deg, total, n_ok, n_slots

    # ----- geometric compaction (amortized-O(m) streaming) ----------------
    def _compact_stream(
        self,
        stream: Callable[[], Iterator[Chunk]],
        alive_c: np.ndarray,
        id_map: np.ndarray,
        pass_idx: int,
    ):
        """Rebuilds the chunk stream over surviving edges with survivors
        renumbered into a dense pow2-padded node range: one extra streaming
        pass on the host, in the reference's order and formats.  Returns
        ``(stream, alive_c, id_map, n_slots)``, ``n_slots`` the PADDED slot
        total of the rebuilt stream (what the next pass streams and the
        rung trigger compares against).

        Without ``spill_dir`` the surviving chunks stay resident in host
        RAM (per-chunk arrays, never concatenated); ``residency_cap_edges``
        counts the source rung plus the survivors so far and turns a
        too-large rebuild into an error.  With ``spill_dir`` they are
        appended to disk-backed memmaps and the rung (``id_map`` included)
        is published atomically, so a resume can re-enter the ladder
        mid-rung; the previous rung directory is removed only after the
        new one is published.
        """
        surv = alive_c[: len(id_map)]
        n_alive = int(surv.sum())
        relabel = (np.cumsum(alive_c) - 1).astype(np.int64)
        # At least one pad node that is never alive, for the edge padding.
        n_pad = pow2_bucket(n_alive + 1, floor=constants.STREAM_REBUILD_NODE_FLOOR)
        pad_id = np.int32(n_pad - 1)

        spill: Optional[EdgeSpillWriter] = None
        rung_dir: Optional[str] = None
        if self.spill_dir is not None:
            rung_dir = os.path.join(self.spill_dir, f"rung_{self.compactions:04d}")
            if os.path.exists(rung_dir):  # stale partial spill from a crash
                shutil.rmtree(rung_dir)
        chunks = []
        caps = []
        n_slots = 0
        w_dtype = None
        try:
            for s, d, w in stream():
                ok = alive_c[s] & alive_c[d]
                kept = int(ok.sum())
                if kept == 0:
                    continue
                # Per-chunk pow2 length: a bounded set of chunk shapes.
                cap = pow2_bucket(kept, floor=constants.STREAM_REBUILD_CHUNK_FLOOR)
                cs = np.full(cap, pad_id, np.int32)
                cd = np.full(cap, pad_id, np.int32)
                cw = np.zeros(cap, w.dtype)
                cs[:kept] = relabel[s[ok]]
                cd[:kept] = relabel[d[ok]]
                cw[:kept] = w[ok]
                n_slots += cap
                w_dtype = w.dtype
                if rung_dir is not None:
                    if spill is None:
                        spill = EdgeSpillWriter(rung_dir, w.dtype)
                    spill.append(cs, cd, cw)
                    caps.append(cap)
                else:
                    # The source rung's chunks stay resident while the new
                    # rung accumulates: the cap and the peak cover both.
                    building = n_slots + self._stream_resident_edges
                    if self.residency_cap_edges is not None and building > self.residency_cap_edges:
                        raise RuntimeError(
                            f"compaction rebuild holds {building} edge slots"
                            " in host RAM (source rung + survivors so far),"
                            f" exceeding residency_cap_edges={self.residency_cap_edges};"
                            " set spill_dir= to rebuild the stream on disk instead"
                        )
                    self.peak_resident_edges = max(self.peak_resident_edges, building)
                    chunks.append((cs, cd, cw))
        except BaseException:
            if spill is not None:
                spill.abort()  # close the files + drop the partial rung
            raise
        new_alive = np.arange(n_pad) < n_alive
        new_id_map = id_map[surv]

        if rung_dir is not None:
            if spill is None:  # no survivors: publish an empty spill
                spill = EdgeSpillWriter(rung_dir, w_dtype if w_dtype is not None else np.float32)
            # repro: allow(fault-sites) spill.finalize fires edgelist.spill_publish inside this try
            try:
                np.save(os.path.join(rung_dir, "id_map.npy"), new_id_map)
                # Publish is atomic (manifest last); a failure aborts the
                # partial rung so resume can never adopt it.
                spill.finalize(
                    caps=caps,
                    n_pad=int(n_pad),
                    n_alive=int(n_alive),
                    n_nodes=int(self.n_nodes),
                    eps=self.eps,  # guards resume against foreign rungs
                    pass_idx=int(pass_idx),
                    rung=int(self.compactions),
                )
            except BaseException:
                spill.abort()
                raise
            prev = self._cur_rung_dir
            self._cur_rung_dir = rung_dir
            if prev is not None and prev != rung_dir:
                shutil.rmtree(prev, ignore_errors=True)
            gen = _spilled_stream(rung_dir)
            self._stream_resident_edges = 0
            self.spill_rungs += 1
        else:

            def gen() -> Iterator[Chunk]:
                yield from chunks

            self._stream_resident_edges = n_slots
        self.compactions += 1
        return gen, new_alive, new_id_map, n_slots

    def _load_spill(self, st: StreamState):
        """Resume hook: re-enter the ladder on the latest finalized spill
        rung consistent with the checkpoint (built from an alive set at
        ``manifest.pass_idx <= st.pass_idx``; alive only shrinks, so
        filtering its chunks by the current alive bitmap is exact).
        Returns ``(stream, alive_c, id_map)`` or None."""
        if self.spill_dir is None or not os.path.isdir(self.spill_dir):
            return None
        best = None
        for name in sorted(os.listdir(self.spill_dir)):
            rung_dir = os.path.join(self.spill_dir, name)
            if not name.startswith("rung_"):
                continue
            opened = open_edge_spill(rung_dir)
            if opened is None:  # unfinalized (crashed mid-spill): ignore
                continue
            man = opened[3]
            if (
                man.get("n_nodes") != self.n_nodes
                or man.get("eps") != self.eps
                or man.get("pass_idx", 1 << 62) > st.pass_idx
            ):
                continue
            if best is None or man["rung"] > best[1]["rung"]:
                best = (rung_dir, man)
        if best is None:
            return None
        rung_dir, man = best
        id_map = np.load(os.path.join(rung_dir, "id_map.npy"))
        alive_c = np.zeros(man["n_pad"], bool)
        alive_c[: len(id_map)] = st.alive[id_map]
        self.compactions = int(man["rung"]) + 1
        self.spill_rungs = int(man["rung"]) + 1
        self._cur_rung_dir = rung_dir
        return _spilled_stream(rung_dir), alive_c, id_map

    # ----- the algorithm ---------------------------------------------------
    def run(self, max_passes: Optional[int] = None, resume: bool = True) -> StreamState:
        """Runs passes until no node is alive or ``max_passes`` (default:
        the Lemma 4 bound); resumes from the checkpoint when ``resume``.
        Returns the state with numpy fields, as the reference's."""
        st = self._load() if resume else None
        fresh = st is None
        if fresh:
            st = StreamState(
                alive=np.ones(self.n_nodes, bool),
                best_alive=np.ones(self.n_nodes, bool),
                best_rho=-np.inf,
                pass_idx=0,
            )
        if max_passes is None:
            max_passes = max_passes_bound(self.n_nodes, self.eps)
        dev = self.device

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # Compact view of the live subproblem: ``id_map`` maps compact ids
        # back to original ids (identity until the first compaction); the
        # full-space state is kept throughout, so the checkpoint format and
        # all outputs are unchanged.
        stream = self.chunk_stream
        id_map = np.arange(self.n_nodes, dtype=np.int64)
        alive_c = st.alive.copy()
        self._stream_resident_edges = 0
        if self.compaction == "geometric" and self.spill_dir is not None:
            if fresh:
                # New lineage: clear rungs of any previous run sharing this
                # spill_dir, so a later resume can never adopt one of them.
                if os.path.isdir(self.spill_dir):
                    for name in os.listdir(self.spill_dir):
                        if name.startswith("rung_"):
                            shutil.rmtree(os.path.join(self.spill_dir, name), ignore_errors=True)
            else:
                rec = self._load_spill(st)
                if rec is not None:
                    stream, alive_c, id_map = rec

        # Device state: the compact alive bitmap the passes read, the
        # full-space alive and best sets (``full``), and id_map.
        alive_dev = to_dev(alive_c)
        full = {"alive": to_dev(st.alive), "best": to_dev(st.best_alive)}
        idm_dev = to_dev(id_map)
        n_cur = int(st.alive.sum())

        def settle() -> None:
            """The full-space bitmaps into ``st`` (one host read)."""
            both = hostsync.fetch(torch.stack([full["alive"], full["best"]]))
            st.alive, st.best_alive = both[0], both[1]

        pending: Optional[_Deferred] = None
        try:
            while n_cur > 0 and st.pass_idx < max_passes:
                deg, total, e_alive_dev, n_slots = self._pass_stats(
                    alive_dev, stream, prelude=pending
                )
                pending = None
                # The removal rule is the engine's; the driver supplies the
                # chunked degree accumulation around it.  One host read a
                # pass: rho, the new alive count, the alive edge count.
                new_alive_dev, rho_dev = undirected_pass_step(
                    alive_dev, deg, total.to(torch.float32), eps=self.eps
                )
                got = hostsync.read(torch.stack(
                    [rho_dev.double(), new_alive_dev.sum().double(), e_alive_dev.double()]
                ))
                rho, n_new, e_alive = got[0], int(got[1]), int(got[2])

                def fin(
                    st=st,
                    prev_full=full["alive"],
                    n_prev=n_cur,
                    e_alive=e_alive,
                    rho=rho,
                    new=new_alive_dev,
                    idm=idm_dev,
                ):
                    st.history.append((n_prev, e_alive, rho))
                    if rho > st.best_rho:
                        st.best_rho = rho
                        full["best"] = prev_full
                    alive_full = torch.zeros(self.n_nodes, dtype=torch.bool, device=dev)
                    alive_full[idm] = new[: len(idm)]
                    full["alive"] = alive_full
                    if self.checkpoint_dir is not None:
                        settle()
                        self._save(st)

                st.pass_idx += 1
                pending = _Deferred(fin)
                alive_dev = new_alive_dev
                n_cur = n_new
                if (
                    self.compaction == "geometric"
                    and n_cur > 0
                    and st.pass_idx < max_passes  # a rebuild needs a consumer
                    and 2 * e_alive < n_slots
                ):
                    pending()  # the rebuild reads a settled checkpoint state
                    pending = None
                    stream, alive_c, id_map, n_slots = self._compact_stream(
                        stream, hostsync.fetch(alive_dev), id_map, st.pass_idx
                    )
                    alive_dev = to_dev(alive_c)
                    idm_dev = to_dev(id_map)
        finally:
            if pending is not None:
                pending()
        settle()
        return st


def _spilled_stream(rung_dir: str) -> Callable[[], Iterator[Chunk]]:
    """Chunk-stream factory over a finalized spill rung: each chunk is a
    memmap slice, read from disk on demand (O(chunk) host residency)."""

    def gen() -> Iterator[Chunk]:
        opened = open_edge_spill(rung_dir)
        if opened is None:
            raise FileNotFoundError(f"no finalized edge spill in {rung_dir}")
        src, dst, w, man = opened
        off = 0
        for cap in man["caps"]:
            yield src[off : off + cap], dst[off : off + cap], w[off : off + cap]
            off += cap

    return gen


def chunked_from_arrays(
    src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray], chunk: int
) -> Callable[[], Iterator[Chunk]]:
    """Chunk-stream factory over in-memory or memmapped edge arrays."""
    if w is None:
        w = np.ones_like(src, np.float32)

    def gen() -> Iterator[Chunk]:
        for lo in range(0, len(src), chunk):
            hi = min(lo + chunk, len(src))
            yield src[lo:hi], dst[lo:hi], w[lo:hi]

    return gen


def chunked_from_memmap(store_dir: str, chunk: int) -> Callable[[], Iterator[Chunk]]:
    """Chunk-stream factory over an on-disk edge store written by
    :func:`repro_torch.graph.edgelist.save_edges_memmap`: each chunk is a
    memmap slice read on demand, so the edges never enter host RAM whole."""

    def gen() -> Iterator[Chunk]:
        src, dst, w = open_edges_memmap(store_dir)
        for lo in range(0, len(src), chunk):
            hi = min(lo + chunk, len(src))
            yield src[lo:hi], dst[lo:hi], w[lo:hi]

    return gen
