"""Training CLI: ``python -m repro_torch.launch.train --arch <id>``
(counterpart of ``repro.launch.train``).

Trains the arch's REDUCED config (the reference's ``--reduced`` is always
on) on a deterministic stream (tokens for the LM family, a fresh 256-node
graph a step for the GNN family, in-batch retrieval batches for recsys)
with AdamW, under the fault-tolerant
``Trainer``: a checkpoint every ``--ckpt-every`` steps, ``--resume`` from
the latest one, optional gradient compression with error feedback.  Runs
on the card unless ``--device cpu`` is given.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict


def build_data(spec, cfg, batch: int, seq: int, seed: int, device):
    from repro_torch.data import pipeline as pl

    if spec.family == "lm":
        return pl.lm_token_stream(cfg.vocab, batch, seq, seed=seed, device=device)
    if spec.family == "recsys":
        return pl.recsys_stream(cfg, batch, seed=seed, device=device)
    if spec.family == "gnn":
        from repro_torch.data.synthetic import make_batch

        shape = dict(n_nodes=256, n_edges=1024, d_feat=cfg.d_in,
                     n_classes=max(cfg.n_classes, 2))

        def make(rng, step):
            return make_batch(spec, "full_train", reduced_shape=shape,
                              seed=int(rng.integers(1 << 31)), device=device)

        return pl.SyntheticStream(make, seed=seed)
    raise ValueError(spec.family)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad-compression", choices=["none", "bf16", "int8"], default="none")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.graph.edgelist import resolve_device
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.optim.compression import (
        CompressionConfig,
        compress_decompress_psum,
        init_error_state,
    )
    from repro_torch.train.step import (
        init_model_params,
        loss_and_grads,
        make_loss_fn,
        specialize_gnn_config,
    )
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced_config
    if spec.family == "gnn":
        cfg = specialize_gnn_config(
            cfg, dict(d_feat=getattr(cfg, "d_in", 16),
                      n_classes=max(getattr(cfg, "n_classes", 2), 2)))
    opt_cfg = AdamWConfig(lr=args.lr, weight_decay=0.01)
    shape_kind = "train" if spec.family != "gnn" else "full_train"
    loss_fn = make_loss_fn(spec, shape_kind, cfg=cfg)
    comp_cfg = CompressionConfig(
        kind={"none": "none", "bf16": "bf16", "int8": "int8_ef"}[args.grad_compression])

    def step_fn(state, batch):
        params, opt, err = state
        _, metrics, grads = loss_and_grads(loss_fn, params, batch)
        # The compressed all-reduce with no group: the quantize/dequantize
        # with error feedback alone, the same numbers as one rank.
        grads, err, _ = compress_decompress_psum(grads, err, comp_cfg)
        params, opt, om = apply_updates(params, grads, opt, opt_cfg)
        return (params, opt, err), {**metrics, **om}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model_params(spec, gen, cfg=cfg, device=dev)
    opt = init_state(params, opt_cfg)
    err = init_error_state(params) if comp_cfg.kind == "int8_ef" else None
    data = build_data(spec, cfg, args.batch, args.seq, args.seed, dev)

    ckpt_dir = args.ckpt_dir or os.path.join("experiments", "train", "torch", args.arch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                         ckpt_every=args.ckpt_every, metrics_path=args.metrics)
    trainer = Trainer(tcfg, step_fn, (params, opt, err), data)
    if args.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step}")
    out = trainer.run()
    first = trainer.metrics_log[0]["loss"] if trainer.metrics_log else float("nan")
    print(json.dumps({
        "arch": args.arch, "device": str(dev), "status": out["status"], "steps": out["step"],
        "first_loss": first, "final_loss": out.get("loss"),
        "wall_s": round(out.get("wall_s", 0), 1),
    }))
    return out


if __name__ == "__main__":
    main()
