"""Writes tests/fixtures/torch_port/golden.json: the JAX package's answers
on two graphs, for the PyTorch port to meet on a machine without JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_port_golden.py

Each entry is Algorithm 1 at eps=0.5 through ``repro`` on the CPU, for
backend ``exact`` and ``pallas``, recorded as ``best_size``, ``passes``,
``best_density`` (the float32's bits as 8 hex digits) and the sha256 of
``best_alive`` packed as bits (``numpy.packbits``).  ``chip_smoke.py``
holds the port's CUDA answers against it, and ``tests/test_torch_golden.py``
recomputes it, so the file cannot go stale.

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
GRAPHS = {
    "quickstart": ("planted_dense_subgraph", dict(n=2000, avg_deg=4, k=60, p_dense=0.6, seed=7)),
    "chung_lu_200k": ("chung_lu_power_law", dict(n=200_000, seed=0)),
}
ORACLE_TILE = 65536


def f32_hex(x) -> str:
    return format(int(np.asarray(x, np.float32).view(np.uint32)), "08x")


def bitmap_sha256(alive) -> str:
    return hashlib.sha256(np.packbits(np.asarray(alive, bool)).tobytes()).hexdigest()


def record(best_alive, best_density, best_size, passes) -> dict:
    return {
        "best_size": int(best_size),
        "best_density_f32": f32_hex(best_density),
        "passes": int(passes),
        "best_alive_sha256": bitmap_sha256(best_alive),
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
    if backend == "pallas" and name == "chung_lu_200k":
        from repro.kernels.peel_degree.ops import degree_fn_from_tiling, tiling_for_edges

        tiled = tiling_for_edges(edges, tile_size=ORACLE_TILE, block=512)
        res = solve(edges, Problem.undirected(eps=EPS),
                    degree_fn=degree_fn_from_tiling(tiled, use_pallas=False))
    else:
        res = solve(edges, Problem.undirected(eps=EPS, backend=backend))
    return record(res.best_alive, res.best_density, res.best_size, res.passes)


def compute() -> dict:
    return {
        "eps": EPS,
        "graphs": {name: {"generator": gen, "kwargs": kw} for name, (gen, kw) in GRAPHS.items()},
        "answers": {
            name: {be: reference_entry(name, be) for be in BACKENDS} for name in GRAPHS
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
