"""Dynamic graph stream on the port: maintain the densest subgraph under
churn (counterpart of ``examples/turnstile_churn.py``).

    PYTHONPATH=src python examples/torch_port/turnstile_churn.py [--n 50000] [--device cpu]

Edges arrive in batches of insertions and deletions; an ℓ0-sampling sketch
absorbs them on the device (the kernel K3, one launch a batch on the
card), and "how dense is the graph right now?" is answered between
batches by recovering the sketch's uniform edge sample and peeling only
the sample: (1+eps)(2+2eps)-approximate, with O(tau·log n) memory
independent of the stream length.

  1. a power-law graph with a planted dense block arrives in insert
     batches; after each, ``TurnstileDensityService`` reports the density;
  2. churn deletes a third of the stream, most of the planted block first,
     and the density falls back;
  3. every reported density is checked against an exact insert-mode peel
     of the surviving graph (``apply_updates``, the host reference);
  4. repeated reads between updates are served from the service's cache;
     the K3 launches equal the update batches (0 on the CPU, where the
     plain version runs).
"""

import argparse
import time

import numpy as np

from repro_torch.core import Problem, solve
from repro_torch.graph.edgelist import apply_updates, from_numpy
from repro_torch.graph.generators import planted_dense_subgraph
from repro_torch.kernels.l0_sampler.ops import l0_delta
from repro_torch.serve import TurnstileDensityService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--avg-deg", type=float, default=6.0)
    ap.add_argument("--planted-k", type=int, default=200)
    ap.add_argument("--planted-p", type=float, default=0.5)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--eps", type=float, default=0.3)
    ap.add_argument("--sample-edges", type=int, default=1 << 13)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)

    g, planted = planted_dense_subgraph(args.n, args.avg_deg, args.planted_k, args.planted_p,
                                        seed=0, device="cpu")
    m = int(g.mask.sum())
    src = g.src[:m].numpy().copy()
    dst = g.dst[:m].numpy().copy()
    envelope = (1 + args.eps) * (2 + 2 * args.eps)
    print(f"stream: {m} edges over {args.n} nodes, "
          f"{len(planted)}-node planted block, envelope {envelope:.2f}x")

    svc = TurnstileDensityService(
        args.n,
        Problem.undirected(eps=args.eps, stream_mode="turnstile",
                           sample_edges=args.sample_edges),
        device=args.device,
    )
    exact_prob = Problem.undirected(eps=args.eps, compaction="off")
    launches0 = l0_delta.launches

    def check(live_edges, label):
        t0 = time.perf_counter()
        est = svc.density()
        dt = time.perf_counter() - t0
        exact = float(solve(live_edges, exact_prob).best_density)
        ratio = est / max(exact, 1e-9)
        ok = 1.0 / envelope <= ratio <= envelope
        lvl = svc.result().extras["turnstile"]["level"]
        print(f"  {label}: density ~{est:8.2f}  exact {exact:8.2f}  "
              f"ratio {ratio:.3f} {'OK' if ok else 'OUT OF ENVELOPE'}  "
              f"(sample level {lvl}, query {dt * 1e3:.1f} ms)")
        assert ok, f"{label}: ratio {ratio} outside {envelope}"

    # -- 1. the graph arrives in insert batches ---------------------------------
    print(f"\ninserting in {args.batches} batches:")
    live = None
    step = -(-m // args.batches)
    for b in range(args.batches):
        lo, hi = b * step, min((b + 1) * step, m)
        batch = np.stack([src[lo:hi], dst[lo:hi]], axis=1)
        svc.apply(insert_edges=batch)
        if live is None:
            live = from_numpy(src[lo:hi], dst[lo:hi], args.n, device=args.device)
        else:
            live, _ = apply_updates(live, inserts=batch)
        check(live, f"after insert batch {b + 1}/{args.batches}")

    # -- 2. churn: delete a third of the stream, the planted block first -------
    rng = np.random.default_rng(1)
    block = np.isin(src, planted) & np.isin(dst, planted)
    background = np.nonzero(~block)[0]
    kill = np.concatenate([
        np.nonzero(block)[0],
        rng.choice(background, size=m // 3 - int(block.sum()), replace=False),
    ])
    deletes = np.stack([src[kill], dst[kill]], axis=1)
    print(f"\nchurn: deleting {len(kill)} edges "
          f"({int(block.sum())} of them from the planted block):")
    svc.apply(delete_edges=deletes)
    live, stats = apply_updates(live, deletes=deletes)
    assert stats["missing_deletes"] == 0
    check(live, "after churn")

    # -- 3. reads between updates hit the cache ---------------------------------
    for _ in range(100):
        svc.density()
    s = svc.stats()
    print(f"\nservice stats: {s}")
    assert s["queries_computed"] == args.batches + 1, s
    k3 = l0_delta.launches - launches0
    print(f"  {s['queries_served']} reads served by "
          f"{s['queries_computed']} sampled peels; "
          f"{s['batches_applied']} update batches, {k3} K3 launches")


if __name__ == "__main__":
    main()
