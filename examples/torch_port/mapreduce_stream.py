"""End-to-end driver on the port: the paper's kind of workload at example
scale (counterpart of ``examples/mapreduce_stream.py``).

    PYTHONPATH=src python examples/torch_port/mapreduce_stream.py [--n 2000000] [--device cpu]

A power-law graph (2M nodes, ~8M edges by default) is processed four ways:

  1. SEMI-STREAMING (paper §4.1): the multi-pass chunked edge stream with
     O(n) node state on the device, per-pass atomic checkpoints and
     speculative re-issue of straggling chunks; stopped after 4 passes and
     resumed from the checkpoint.
  2. OUT-OF-CORE SPILL LADDER: the same stream from an on-disk memmap edge
     store through the geometric compaction ladder with a residency cap
     smaller than the ladder's survivors, so the rebuilt survivor streams
     spill to disk and host RAM holds only the pipeline's prefetch window.
  3. MAPREDUCE ANALOGUE (paper §5.2): the mesh substrate, edges sharded
     over the ranks of ``make_mesh`` (one rank per process; ``torchrun
     --nproc-per-node=N`` for more), one ``all_reduce`` a pass.
  4. TWO-PHASE COMPACTED peel on the same mesh (beyond the paper), and the
     Count-Sketch memory mode (§5.1; its counters built by the kernel K2).

All exact modes must agree (the Count-Sketch variant within its
approximation).  A process group started here is destroyed before exit.
"""

import argparse
import os
import time

import torch.distributed as dist

from repro_torch.core import (
    Problem,
    StreamingDensest,
    chunked_from_arrays,
    chunked_from_memmap,
    make_mesh,
    solve,
)
from repro_torch.core.mapreduce import make_distributed_peel_twophase, shard_edges
from repro_torch.graph.edgelist import save_edges_memmap
from repro_torch.graph.generators import chung_lu_power_law


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--avg-deg", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=None,
                    help="stream chunk size (default: ~m/8)")
    ap.add_argument("--scratch", default="experiments/stream_ckpt",
                    help="checkpoint / edge-store / spill scratch dir")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)

    edges = chung_lu_power_law(n=args.n, exponent=2.0, avg_deg=args.avg_deg, seed=42,
                               device=args.device)
    dev = edges.device
    n, m = edges.n_nodes, int(edges.num_real_edges())
    chunk = args.chunk or max(m // 8, 1024)
    print(f"graph: n={n:,} m={m:,} chunk={chunk:,}")
    src = edges.src.cpu().numpy()
    dst = edges.dst.cpu().numpy()

    # ---- 1. semi-streaming with checkpoint/restart + stragglers ------------
    ckpt_dir = args.scratch
    if os.path.exists(os.path.join(ckpt_dir, "stream_state.npz")):
        os.unlink(os.path.join(ckpt_dir, "stream_state.npz"))
    stream = chunked_from_arrays(src, dst, None, chunk=chunk)

    t0 = time.time()
    sd = StreamingDensest(stream, n, eps=0.5, checkpoint_dir=ckpt_dir, device=dev)
    st = sd.run(max_passes=4)  # a preemption after 4 passes
    print(f"[stream] preempted at pass {st.pass_idx}, "
          f"best rho so far {st.best_rho:.3f} (checkpoint saved)")
    sd2 = StreamingDensest(stream, n, eps=0.5, checkpoint_dir=ckpt_dir, device=dev)
    st = sd2.run(resume=True)  # picks up at pass 4
    rho_stream = st.best_rho
    print(f"[stream] resumed + finished: rho={rho_stream:.4f} "
          f"passes={st.pass_idx} wall={time.time() - t0:.1f}s "
          f"speculative_reissues={sd2.speculative_reissues}")

    # ---- 1b. out-of-core: memmap store + spilled compaction ladder ---------
    store = save_edges_memmap(os.path.join(args.scratch, "edge_store"), src, dst)
    chunk_ooc = max(m // 64, 256)
    # Rebuilt spill chunks are pow2-padded (<= 2x the input chunk), so the
    # 4-chunk window is bounded by 8 x chunk_ooc ~ m/8: far below the
    # ladder's survivor count (just under m/2 at the first trigger).
    cap = 8 * chunk_ooc
    t0 = time.time()
    ooc = StreamingDensest(
        chunked_from_memmap(store, chunk=chunk_ooc), n, eps=0.5,
        compaction="geometric", prefetch=4,
        spill_dir=os.path.join(args.scratch, "spill"),
        residency_cap_edges=cap, device=dev,
    )
    st_ooc = ooc.run(resume=False)
    print(f"[out-of-core] rho={st_ooc.best_rho:.4f} passes={st_ooc.pass_idx} "
          f"wall={time.time() - t0:.1f}s spill_rungs={ooc.spill_rungs} "
          f"peak_resident={ooc.peak_resident_edges:,}/{m:,} edges (cap {cap:,})")
    assert ooc.peak_resident_edges <= cap
    assert st_ooc.best_rho == rho_stream
    assert (st_ooc.best_alive == st.best_alive).all()

    # ---- 2. the mesh substrate over this process's world ----------------------
    started = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", 1)) if started else dist.get_world_size()
    mesh = make_mesh((world,), ("data",), device=dev)
    try:
        t0 = time.time()
        res = solve(edges, Problem.undirected(eps=0.5, substrate="mesh"), mesh=mesh)
        rho_dist = float(res.best_density)
        print(f"[mapreduce x{world}rank] rho={rho_dist:.4f} passes={int(res.passes)} "
              f"wall={time.time() - t0:.1f}s (one all_reduce a pass)")

        # ---- 3. two-phase compacted peel (beyond the paper) ------------------
        sh = shard_edges(edges, mesh, ("data",))
        two = make_distributed_peel_twophase(mesh, ("data",), eps=0.5, n_nodes=sh.n_nodes,
                                             phase1_passes=6)
        t0 = time.time()
        r2 = two(sh.src, sh.dst, sh.weight, sh.mask)
        print(f"[two-phase]  rho={float(r2.best_density):.4f} passes={int(r2.passes)} "
              f"wall={time.time() - t0:.1f}s (phase-2 ids compacted)")
    finally:
        if started:
            dist.destroy_process_group()

    # ---- 4. Count-Sketch memory mode (paper §5.1) ----------------------------
    sk = solve(edges, Problem.undirected(eps=0.5, backend="sketch", sketch_tables=5,
                                         sketch_buckets=1 << 16))
    print(f"[sketch t=5 b=65536] rho={float(sk.best_density):.4f} "
          f"(node-state memory {5 * (1 << 16) / n:.1%} of exact)")

    assert abs(rho_stream - rho_dist) < 1e-3
    assert abs(float(r2.best_density) - rho_dist) < 1e-3
    print("\nall exact modes agree ✓")


if __name__ == "__main__":
    main()
