"""Community mining -> GNN training on the port: the paper's community
application feeding the training stack end to end (counterpart of
``examples/community_gnn.py``).

    PYTHONPATH=src python examples/torch_port/community_gnn.py [--device cpu]

1. Peels node-disjoint dense communities out of a planted-partition graph
   one after another (the paper's §6 enumeration note), each through
   Algorithm 1 (``densest_subgraph_sets``, the exact backend) on the
   edges left.
2. Uses community membership as (noisy) node labels and trains GraphSAGE
   with the layered neighbor sampler, the fault-tolerant ``Trainer`` and
   its asynchronous checkpoints, then restarts from the checkpoint at step
   150 and trains on to step 200.

The graph, the model and its optimizer state live on ``--device``
(default: the card); the sampler draws on the host.  The communities, their
densities and purities equal the reference example's; the GraphSAGE
weights are drawn from a ``torch.Generator``, so its losses do not.
"""

import argparse
import dataclasses
import shutil
import time

import numpy as np
import torch

from repro_torch.core import densest_subgraph_sets
from repro_torch.graph.edgelist import from_numpy, resolve_device
from repro_torch.graph.generators import planted_partition
from repro_torch.graph.sampler import CSRGraph, LayeredSampler


def peel_communities(edges, k_communities: int, eps: float = 0.5):
    """Node-disjoint (approximate) densest subgraphs, greedily removed."""
    src = edges.src.cpu().numpy()
    dst = edges.dst.cpu().numpy()
    n = edges.n_nodes
    removed = np.zeros(n, bool)
    communities = []
    for _ in range(k_communities):
        keep = ~(removed[src] | removed[dst])
        sub = from_numpy(src[keep], dst[keep], n, device=edges.device)
        nodes, rho = densest_subgraph_sets(sub, eps=eps)
        nodes = np.asarray([u for u in nodes if not removed[u]])
        if len(nodes) == 0:
            break
        communities.append((nodes, rho))
        removed[nodes] = True
    return communities


class SamplerStream:
    """The sampler's host hop arrays as tensors on the device, beside the
    feature table; resumable through the sampler's cursor."""

    def __init__(self, sampler, feats, device):
        self.s, self.feats, self.device = sampler, feats, device

    def __next__(self):
        b = next(self.s)
        return {"feat_table": self.feats,
                **{k: torch.from_numpy(v).to(self.device) for k, v in b.items()}}

    def checkpoint_state(self):
        return self.s.checkpoint_state()

    def restore(self, st):
        self.s.restore(st)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="experiments/torch/community_gnn_ckpt")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' when asked")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, k = 3000, 4
    # Heterogeneous densities: the peel extracts communities densest-first
    # (with uniform p_in the UNION has the same density as each block and
    # the algorithm correctly returns the whole graph).
    edges, truth = planted_partition(
        n=n, k=k, p_in=(0.20, 0.12, 0.08, 0.05), p_out=0.0005, seed=11, device=dev
    )
    print(f"graph: n={n} m={int(edges.num_real_edges())}, {k} planted communities")

    comms = peel_communities(edges, k)
    labels = np.full(n, k, np.int32)  # background class k
    for ci, (nodes, rho) in enumerate(comms):
        labels[nodes] = ci
        purity = np.bincount(truth[nodes], minlength=k).max() / len(nodes)
        print(f"community {ci}: |S|={len(nodes):4d} rho={rho:6.2f} purity={purity:.0%}")

    # ---- GraphSAGE on the mined labels ------------------------------------
    from repro_torch.configs import get_arch
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.train.step import (
        init_model_params,
        loss_and_grads,
        make_loss_fn,
        specialize_gnn_config,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig

    spec = get_arch("graphsage-reddit")
    cfg = specialize_gnn_config(spec.reduced_config, dict(d_feat=16, n_classes=k + 1))
    g = CSRGraph.from_edges(edges.src.cpu().numpy(), edges.dst.cpu().numpy(), n, device=dev)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, 16)).astype(np.float32)
    feats[:, 0] = labels == 0  # weakly informative features
    feats_t = torch.from_numpy(feats).to(dev)
    sampler = LayeredSampler(g, labels, batch_nodes=64, fanout=(5, 3), seed=1)

    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    loss_fn = make_loss_fn(spec, "sampled_train", cfg=cfg)

    def step_fn(state, batch):
        params, opt = state
        _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        params, opt, om = apply_updates(params, grads, opt, opt_cfg)
        return (params, opt), {**metrics, **om}

    def fresh_state():
        params = init_model_params(spec, torch.Generator(device=dev).manual_seed(0), cfg=cfg,
                                   device=dev)
        return params, init_state(params, opt_cfg)

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    tcfg = TrainerConfig(total_steps=150, ckpt_dir=args.ckpt_dir, ckpt_every=50)
    tr = Trainer(tcfg, step_fn, fresh_state(), SamplerStream(sampler, feats_t, dev))
    t0 = time.time()
    out = tr.run()
    first = tr.metrics_log[0]["loss"]
    print(
        f"\nGraphSAGE on mined communities: loss {first:.3f} -> "
        f"{out['loss']:.3f} in {out['step']} steps ({time.time() - t0:.0f}s)"
    )

    # resume path: restart and train 50 more steps from the checkpoint
    tr2 = Trainer(dataclasses.replace(tcfg, total_steps=200), step_fn, fresh_state(),
                  SamplerStream(sampler, feats_t, dev))
    assert tr2.try_restore() and tr2.step == 150
    out2 = tr2.run()
    print(f"resumed at 150 -> {out2['step']}: loss {out2['loss']:.3f}")
    return {"communities": comms, "first_loss": first, "loss_150": out["loss"],
            "resumed": out2}


if __name__ == "__main__":
    main()
