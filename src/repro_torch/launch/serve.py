"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> --requests N``
(counterpart of ``repro.launch.serve``).

Runs the continuous-batching engine (serve/engine.py) on a REDUCED config
with synthetic prompts and prints one JSON line of throughput.  Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.graph.edgelist import resolve_device
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.step import init_model_params

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("the serving driver is for the LM family")
    cfg = dataclasses.replace(spec.reduced_config, remat=False)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model_params(spec, gen, cfg=cfg, device=dev)
    rng = np.random.default_rng(args.seed)

    eng = ServeEngine(params, cfg, n_slots=args.slots, max_len=args.max_len, device=dev)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.integers(4, 17))
        eng.submit(
            Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab, plen, dtype=np.int32),
                max_new=args.max_new,
            )
        )
    done = eng.run_to_completion()
    wall = time.time() - t0
    toks = sum(len(r.tokens) for r in done)
    print(
        json.dumps(
            {
                "arch": args.arch,
                "device": str(dev),
                "requests": len(done),
                "generated_tokens": toks,
                "wall_s": round(wall, 2),
                "tok_per_s": round(toks / wall, 1),
            }
        )
    )
    return done


if __name__ == "__main__":
    main()
