"""Writes tests/fixtures/torch_port/golden.json: the JAX package's answers
on two graphs, for the PyTorch port to meet on a machine without JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_golden.py

Each entry is Algorithm 1 at eps=0.5 through ``repro`` on the CPU, for
the cells ``exact``, ``pallas``, ``sketch`` (``backend='sketch'``, §5.1
Count-Sketch at its defaults t=5, b=8192, seed 0) and ``turnstile`` (a
one-shot ``stream_mode='turnstile'`` solve: every edge inserted as one
batch into the ℓ0 sketch, one query), recorded as ``best_size``,
``passes``, ``best_density`` (the float32's bits as 8 hex digits) and the
sha256 of ``best_alive`` packed as bits (``numpy.packbits``).  A sketch
entry adds the sha256 of the first pass's float32 counters (every edge
alive); a turnstile entry adds the sha256 of the int32 sketch tables after
the insert, of the recovered int32 ``[k, 2]`` edge array, and the level it
decoded at.  ``chip_smoke.py`` holds the port's CUDA answers against it,
and ``tests/test_torch_golden.py`` recomputes it, so the file cannot go
stale.

The pallas entries come from the reference's tiled-degree kernel K1: the
quickstart graph through the real ``backend='pallas'`` cell (Pallas in
interpret mode off-TPU); the 200k graph through K1's jnp oracle
(``use_pallas=False``) at ``tile_size=65536``, because interpret mode over
the dense tile layout at the default 1024 (86M padded slots) does not fit a
CPU run.  The tile width changes only the layout, not the sums: with unit
weights every degree is an exact integer.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "torch_port", "golden.json")
EPS = 0.5
BACKENDS = ("exact", "pallas")
CELLS = BACKENDS + ("sketch", "turnstile")
GRAPHS = {
    "quickstart": ("planted_dense_subgraph", dict(n=2000, avg_deg=4, k=60, p_dense=0.6, seed=7)),
    "chung_lu_200k": ("chung_lu_power_law", dict(n=200_000, seed=0)),
}
ORACLE_TILE = 65536


def f32_hex(x) -> str:
    return format(int(np.asarray(x, np.float32).view(np.uint32)), "08x")


def bitmap_sha256(alive) -> str:
    return hashlib.sha256(np.packbits(np.asarray(alive, bool)).tobytes()).hexdigest()


def array_sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def record(best_alive, best_density, best_size, passes, **extra) -> dict:
    return {
        "best_size": int(best_size),
        "best_density_f32": f32_hex(best_density),
        "passes": int(passes),
        "best_alive_sha256": bitmap_sha256(best_alive),
        **extra,
    }


def sketch_extra(counters) -> dict:
    """The sketch entry's extra field: float32[t, b] first-pass counters."""
    return {"counters_sha256": array_sha256(np.asarray(counters, np.float32))}


def turnstile_extra(tables, edges, level) -> dict:
    """The turnstile entry's extra fields."""
    return {
        "tables_sha256": array_sha256(np.asarray(tables, np.int32)),
        "edges_sha256": array_sha256(np.asarray(edges, np.int32)),
        "level": int(level),
    }


def make_graph(name: str):
    from repro.graph import generators

    gen, kw = GRAPHS[name]
    out = getattr(generators, gen)(**kw)
    return out[0] if isinstance(out, tuple) else out


def reference_entry(name: str, backend: str) -> dict:
    """One golden entry, computed by the JAX package."""
    from repro.core import Problem, solve

    edges = make_graph(name)
    if backend == "sketch":
        import jax.numpy as jnp

        from repro.core.countsketch import make_sketch_params, sketch_degrees_from_edges
        from repro.core.density import alive_edge_weight

        prob = Problem.undirected(eps=EPS, backend="sketch")
        res = solve(edges, prob)
        params = make_sketch_params(prob.sketch_tables, prob.sketch_buckets, prob.sketch_seed)
        w = alive_edge_weight(edges, jnp.ones(edges.n_nodes, bool))
        return record(res.best_alive, res.best_density, res.best_size, res.passes,
                      **sketch_extra(sketch_degrees_from_edges(params, edges, w)))
    if backend == "turnstile":
        from repro.core.turnstile import TurnstileDensest

        prob = Problem.undirected(eps=EPS, stream_mode="turnstile")
        res = solve(edges, prob)
        mask = np.asarray(edges.mask)
        td = TurnstileDensest(edges.n_nodes, prob)
        td.apply(insert_edges=(np.asarray(edges.src)[mask], np.asarray(edges.dst)[mask]))
        sample, level, _ = td.sketch.recover()
        return record(res.best_alive, res.best_density, res.best_size, res.passes,
                      **turnstile_extra(td.sketch.tables, sample, level))
    if backend == "pallas" and name == "chung_lu_200k":
        from repro.kernels.peel_degree.ops import degree_fn_from_tiling, tiling_for_edges

        tiled = tiling_for_edges(edges, tile_size=ORACLE_TILE, block=512)
        res = solve(edges, Problem.undirected(eps=EPS),
                    degree_fn=degree_fn_from_tiling(tiled, use_pallas=False))
    else:
        res = solve(edges, Problem.undirected(eps=EPS, backend=backend))
    return record(res.best_alive, res.best_density, res.best_size, res.passes)


def port_entry(edges, cell: str) -> dict:
    """The PyTorch port's answer for one cell on ``edges`` (on any device),
    in the golden record's form: what ``tests/test_torch_golden.py`` (CPU)
    and ``chip_smoke.py`` (CUDA) hold against the fixture."""
    import torch

    from repro_torch.core import Problem, solve

    extra = {}
    if cell in BACKENDS:
        res = solve(edges, Problem.undirected(eps=EPS, backend=cell))
    elif cell == "sketch":
        from repro_torch.core.countsketch import make_sketch_params, sketch_degrees_from_edges
        from repro_torch.core.density import alive_edge_weight

        prob = Problem.undirected(eps=EPS, backend="sketch")
        res = solve(edges, prob)
        params = make_sketch_params(prob.sketch_tables, prob.sketch_buckets, prob.sketch_seed)
        w = alive_edge_weight(edges, torch.ones(edges.n_nodes, dtype=torch.bool,
                                                device=edges.device))
        extra = sketch_extra(sketch_degrees_from_edges(params, edges, w).cpu().numpy())
    else:
        from repro_torch.core.turnstile import TurnstileDensest

        prob = Problem.undirected(eps=EPS, stream_mode=cell)
        res = solve(edges, prob)
        td = TurnstileDensest(edges.n_nodes, prob, device=edges.device)
        td.apply(insert_edges=(edges.src[edges.mask], edges.dst[edges.mask]))
        sample, level, _ = td.sketch.recover()
        extra = turnstile_extra(td.sketch.tables.cpu().numpy(), sample, level)
    return record(res.best_alive.cpu().numpy(), res.best_density.cpu().numpy(),
                  res.best_size.cpu(), res.passes, **extra)


def compute() -> dict:
    return {
        "eps": EPS,
        "graphs": {name: {"generator": gen, "kwargs": kw} for name, (gen, kw) in GRAPHS.items()},
        "answers": {
            name: {cell: reference_entry(name, cell) for cell in CELLS} for name in GRAPHS
        },
    }


def main() -> int:
    golden = compute()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    tmp = GOLDEN + ".tmp"
    with open(tmp, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, GOLDEN)
    print(json.dumps(golden["answers"], indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
