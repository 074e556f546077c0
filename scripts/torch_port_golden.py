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

The ``objectives`` section holds Algorithms 2 and 3 and one sweep, each
case named ``<objective>.<graph>[.<backend>]``: ``at_least_k`` with k=60
on the quickstart graph and k=20,000 on the 200k graph (exact and pallas,
the 200k pallas entry through K1's jnp oracle as above); ``directed`` on a
seeded ``directed_planted`` graph of 20,000 nodes with a fixed c=4.0 and
with the c grid (``best_c`` and the passes of each c added); and a 3-lane
``solve_batch`` eps sweep [0.25, 0.5, 1.0] on the quickstart graph under
``backend='pallas'``, one record a lane.  A directed record adds
``t_size``, the sha256 of ``best_t`` and ``edges_in`` = |E(S, T)|, and
its ``best_density_f32`` is recomputed from the reference's sets in IEEE
float32 (``edges_in / sqrt(|S|·|T|)``): XLA's CPU code multiplies by an
approximate rsqrt, within 1 ulp of that value, while the port divides.

The ``lm`` section holds the reference LM's answers on the REDUCED
llama3.2-3b at ``compute_dtype=float32``, with parameters drawn by numpy
from seed 0 (:func:`lm_params`, the same arrays for both packages), for two
cases: a dense cache, and ``window=16`` with a 40-token prompt.  Each
records, per prompt, the last-position logits of ``prefill`` under
``attn_impl='pallas'`` (the reference's flash kernel in interpret mode) as
floats, the ``ServeEngine`` greedy tokens under ``attn_impl='xla'``, and
the top-1/top-2 logit margin of each of those tokens under a full
``forward`` of the prompt and the tokens before it: a margin far above the
logits' tolerance means no rounding on the card can flip the token.

The ``lm_moe`` section holds the same records for the REDUCED mixtral-8x7b
and llama4-maverick-400b-a17b (one case each, :data:`LM_MOE_CASE`: prompts
of 16 and 48 tokens, whose least margin is far above the tolerance), plus a
digest of one ``forward`` over a seeded 2 x 64 batch at the config's own
capacity, where tokens drop: each row's last-position logits, each
position's largest logit, ``moe_loss`` and each layer's ``moe_drop_frac``
(from the layers run one by one, whose ``_ffn_block`` returns the MoE aux).

The ``serve`` section holds per-seed serving on the two graphs, each case
named ``<kind>.<graph>``: ``engine.bfs`` and ``engine.local`` are the
reference ``DensestQueryEngine``'s answers (radius 1, 128 ego nodes, 16
queries a batch, eps 0.5, 32 passes, compaction off; the local mode at its
defaults: budget 512, 8 rounds, alpha 1) for :data:`SERVE_QUERIES` seeds of
degree >= 1 drawn by ``numpy.random.default_rng(0)``, one record a query
(``seed``, ``size``, ``density_f32``, ``seed_in_set``, ``n_ego``, ``m_ego``,
``bucket`` and the sha256 of the int64 ``nodes``); ``local`` is the
reference's ``solve(graph, Problem(substrate='local'), seed=s)`` for the
first :data:`SERVE_FRONT_DOOR` of those seeds, each a ``record`` plus the
exploration counters of ``extras['local']`` and the sha256 of its
candidate set.

The ``streaming`` section holds the semi-streaming substrate,
``solve(graph, Problem.undirected(eps=0.5, substrate='streaming', ...))``,
each case named ``<graph>.<compaction>[.chunk<N>]``: compaction ``off`` and
``geometric`` at the default ``stream_chunk`` (2^20) on both graphs, and
the geometric ladder on the quickstart graph in 1,000-edge chunks.  A
record adds the sha256 of the history (int32 ``history_n``, then float32
``history_m`` and ``history_rho``) and the ladder's ``compactions``.

The ``mesh`` section holds the §5.2 mesh substrate on an edge-sharded
mesh of :data:`MESH_DEVICES` devices, ``solve(graph,
Problem.undirected(eps=0.5, substrate='mesh', track_history=True, ...),
mesh=mesh)``, each case named ``<graph>.<compaction>[.bf16]``: the
collective ladder (compaction ``geometric``) and the host ``twophase``
ladder (one compaction after 2 passes), and the bf16 wire (``wire_dtype='bf16'``) uncompacted.  The JAX
package computes them in a child process that forces
:data:`MESH_DEVICES` host devices (``--xla_force_host_platform_device_count``),
so this process keeps its one device.  A record adds the history's
sha256 and, for a ladder, its report without ``cache_hit``.  The port
meets them with :data:`MESH_DEVICES` gloo ranks
(``tests/test_torch_mapreduce.py``).

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
import subprocess
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
AT_LEAST_K = {"quickstart": 60, "chung_lu_200k": 20_000}
DIRECTED_GRAPH = ("directed_planted",
                  dict(n=20_000, avg_deg=5.0, ks=200, kt=50, p_dense=0.3, seed=0))
DIRECTED_C = 4.0
SWEEP_EPS = (0.25, 0.5, 1.0)
OBJECTIVE_CASES = tuple(
    [f"at_least_k.{g}.{b}" for g in AT_LEAST_K for b in BACKENDS]
    + ["directed.fixed_c", "directed.grid", "sweep.quickstart"]
)
SERVE_PROBLEM = dict(eps=EPS, max_passes=32, compaction="off")
SERVE_ENGINE = dict(radius=1, max_ego_nodes=128, max_batch=16, max_wait_ms=0.0)
SERVE_QUERIES = 24
SERVE_FRONT_DOOR = 4
SERVE_CASES = tuple(f"{kind}.{g}" for kind in ("engine.bfs", "engine.local", "local")
                    for g in GRAPHS)
STREAM_CASES = {
    **{f"{g}.{c}": dict(compaction=c) for g in GRAPHS for c in ("off", "geometric")},
    "quickstart.geometric.chunk1000": dict(compaction="geometric", stream_chunk=1000),
}
MESH_DEVICES = 4
MESH_CASES = {
    **{f"{g}.geometric": dict(compaction="geometric") for g in GRAPHS},
    **{f"{g}.twophase": dict(compaction="twophase", twophase_passes=2) for g in GRAPHS},
    **{f"{g}.off.bf16": dict(compaction="off", wire_dtype="bf16") for g in GRAPHS},
}


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


# -- the objectives entries (Algorithms 2 and 3, one sweep) -------------------


def directed_record(src, dst, best_s, best_t, passes, density=None, **extra) -> dict:
    """A directed entry from host arrays of the real edges and the best
    pair; ``density`` None recomputes it in IEEE float32 from the sets."""
    s, t = np.asarray(best_s, bool), np.asarray(best_t, bool)
    m_in = int(np.sum(s[src] & t[dst]))
    ns, nt = int(s.sum()), int(t.sum())
    if density is None:
        density = np.float32(m_in) / np.sqrt(np.float32(max(ns, 1)) * np.float32(max(nt, 1)))
    return {
        "best_size": ns, "t_size": nt, "edges_in": m_in, "passes": int(passes),
        "best_density_f32": f32_hex(density), "best_alive_sha256": bitmap_sha256(s),
        "best_t_sha256": bitmap_sha256(t), **extra,
    }


def _grid_extra(res) -> dict:
    return {"best_c": float(res.extras["best_c"]),
            "c_passes": [int(p) for p in res.extras["c_passes"]]}


def reference_objective_entry(case: str):
    """One objectives entry, computed by the JAX package."""
    from repro.core import Problem, solve, solve_batch

    kind, rest = case.split(".", 1)
    if kind == "at_least_k":
        name, backend = rest.split(".")
        edges = make_graph(name)
        prob = Problem.at_least_k(k=AT_LEAST_K[name], eps=EPS, backend=backend)
        if backend == "pallas" and name == "chung_lu_200k":
            from repro.kernels.peel_degree.ops import degree_fn_from_tiling, tiling_for_edges

            tiled = tiling_for_edges(edges, tile_size=ORACLE_TILE, block=512)
            res = solve(edges, Problem.at_least_k(k=AT_LEAST_K[name], eps=EPS),
                        degree_fn=degree_fn_from_tiling(tiled, use_pallas=False))
        else:
            res = solve(edges, prob)
        return record(res.best_alive, res.best_density, res.best_size, res.passes)
    if kind == "directed":
        from repro.graph import generators

        gen, kw = DIRECTED_GRAPH
        edges = getattr(generators, gen)(**kw)[0]
        c = DIRECTED_C if rest == "fixed_c" else None
        res = solve(edges, Problem.directed(c=c, eps=EPS))
        mask = np.asarray(edges.mask)
        extra = _grid_extra(res) if c is None else {}
        return directed_record(np.asarray(edges.src)[mask], np.asarray(edges.dst)[mask],
                               res.best_alive, res.best_t, res.passes, **extra)
    edges = make_graph(rest)
    res = solve_batch(edges, Problem.undirected(backend="pallas"), eps=list(SWEEP_EPS))
    return [record(res.best_alive[i], res.best_density[i], res.best_size[i], res.passes[i])
            for i in range(len(SWEEP_EPS))]


def port_objective_entry(case: str, device):
    """The port's answer for one objectives case on ``device``, in the
    fixture's form (the directed density is the port's own value)."""
    from repro_torch.core import Problem, solve, solve_batch
    from repro_torch.graph import generators

    def graph(name):
        gen, kw = GRAPHS[name]
        out = getattr(generators, gen)(**kw, device=device)
        return out[0] if isinstance(out, tuple) else out

    kind, rest = case.split(".", 1)
    if kind == "at_least_k":
        name, backend = rest.split(".")
        res = solve(graph(name), Problem.at_least_k(k=AT_LEAST_K[name], eps=EPS,
                                                    backend=backend))
        return record(res.best_alive.cpu().numpy(), res.best_density.cpu().numpy(),
                      res.best_size.cpu(), res.passes)
    if kind == "directed":
        gen, kw = DIRECTED_GRAPH
        edges = getattr(generators, gen)(**kw, device=device)[0]
        c = DIRECTED_C if rest == "fixed_c" else None
        res = solve(edges, Problem.directed(c=c, eps=EPS))
        mask = edges.mask.cpu().numpy()
        extra = _grid_extra(res) if c is None else {}
        return directed_record(edges.src.cpu().numpy()[mask], edges.dst.cpu().numpy()[mask],
                               res.best_alive.cpu().numpy(), res.best_t.cpu().numpy(),
                               res.passes, density=res.best_density.cpu().numpy(), **extra)
    res = solve_batch(graph(rest), Problem.undirected(backend="pallas"), eps=list(SWEEP_EPS))
    return [record(res.best_alive[i].cpu().numpy(), res.best_density[i].cpu().numpy(),
                   res.best_size[i].cpu(), res.passes[i]) for i in range(len(SWEEP_EPS))]


# -- the streaming entries (the semi-streaming substrate) ---------------------


def stream_record(res, host=np.asarray) -> dict:
    """A streaming entry from a result, ``host`` bringing its arrays to
    numpy."""
    hist = b"".join(np.ascontiguousarray(host(getattr(res, f)), dt).tobytes() for f, dt in (
        ("history_n", np.int32), ("history_m", np.float32), ("history_rho", np.float32)))
    return record(host(res.best_alive), host(res.best_density), host(res.best_size),
                  res.passes, history_sha256=hashlib.sha256(hist).hexdigest(),
                  compactions=int(res.extras["streaming"]["compactions"]))


def reference_stream_entry(case: str) -> dict:
    """One streaming entry, computed by the JAX package."""
    from repro.core import Problem, solve

    res = solve(make_graph(case.split(".")[0]),
                Problem.undirected(eps=EPS, substrate="streaming", **STREAM_CASES[case]))
    return stream_record(res)


def port_stream_entry(case: str, device) -> dict:
    """The port's answer for one streaming case, its node state on ``device``."""
    from repro_torch.core import Problem, solve
    from repro_torch.graph import generators

    gen, kw = GRAPHS[case.split(".")[0]]
    out = getattr(generators, gen)(**kw, device=device)
    edges = out[0] if isinstance(out, tuple) else out
    res = solve(edges, Problem.undirected(eps=EPS, substrate="streaming", **STREAM_CASES[case]))
    return stream_record(res, host=lambda t: t.cpu().numpy())


# -- the mesh entries (the §5.2 mesh substrate) -------------------------------


def mesh_problem(case: str, problem_cls):
    """The case's Problem, from either package's ``Problem`` class."""
    return problem_cls.undirected(eps=EPS, substrate="mesh", track_history=True,
                                  **MESH_CASES[case])


def mesh_record(res, host=np.asarray) -> dict:
    """A mesh entry from a result, ``host`` bringing its arrays to numpy."""
    hist = b"".join(np.ascontiguousarray(host(getattr(res, f)), dt).tobytes() for f, dt in (
        ("history_n", np.int32), ("history_m", np.float32), ("history_rho", np.float32)))
    extra = {}
    if res.extras is not None and "compaction" in res.extras:
        lad = dict(res.extras["compaction"])
        lad["segments"] = [{k: v for k, v in seg.items() if k != "cache_hit"}
                           for seg in lad["segments"]]
        extra["ladder"] = lad
    return record(host(res.best_alive), host(res.best_density), host(res.best_size),
                  res.passes, history_sha256=hashlib.sha256(hist).hexdigest(), **extra)


def _reference_mesh_child() -> dict:
    """In a process with :data:`MESH_DEVICES` host devices: every mesh
    entry, computed by the JAX package."""
    import jax

    from repro.core import Problem, solve

    assert len(jax.devices()) == MESH_DEVICES, jax.devices()
    mesh = jax.make_mesh((MESH_DEVICES,), ("data",))
    return {case: mesh_record(solve(make_graph(case.split(".")[0]),
                                    mesh_problem(case, Problem), mesh=mesh))
            for case in MESH_CASES}


def reference_mesh_entries(timeout: float = 900) -> dict:
    """Every mesh entry, computed by the JAX package in a child process
    with :data:`MESH_DEVICES` host devices."""
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={MESH_DEVICES}",
        PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), os.path.join(REPO, "scripts")]),
    )
    code = ("import json, torch_port_golden as g; "
            "print('MESH_JSON ' + json.dumps(g._reference_mesh_child()))")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=timeout, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"mesh reference child failed: {proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MESH_JSON ")][-1]
    return json.loads(line[len("MESH_JSON "):])


def port_mesh_entry(case: str, mesh, device) -> dict:
    """The port's answer for one mesh case on ``mesh``, its graph on
    ``device`` (every rank calls this with the same case)."""
    from repro_torch.core import Problem, solve
    from repro_torch.graph import generators

    gen, kw = GRAPHS[case.split(".")[0]]
    out = getattr(generators, gen)(**kw, device=device)
    edges = out[0] if isinstance(out, tuple) else out
    res = solve(edges, mesh_problem(case, Problem), mesh=mesh)
    return mesh_record(res, host=lambda t: t.cpu().numpy())


# -- the serve entries (per-seed serving and the local front door) ------------


def serve_seeds(indptr) -> list:
    """:data:`SERVE_QUERIES` seeds of degree >= 1, drawn by
    ``numpy.random.default_rng(0)`` from a graph's CSR ``indptr``."""
    candidates = np.nonzero(np.diff(np.asarray(indptr)) > 0)[0]
    rng = np.random.default_rng(0)
    return [int(s) for s in rng.choice(candidates, SERVE_QUERIES, replace=False)]


def query_record(r) -> dict:
    """One ``QueryResult`` in the fixture's form."""
    return {
        "seed": int(r.seed), "size": int(len(r.nodes)), "density_f32": f32_hex(r.density),
        "seed_in_set": bool(r.seed_in_set), "n_ego": int(r.n_ego), "m_ego": int(r.m_ego),
        "bucket": [int(b) for b in r.bucket],
        "nodes_sha256": array_sha256(np.asarray(r.nodes, np.int64)), "status": r.status,
    }


def local_record(best_alive, best_density, best_size, passes, info) -> dict:
    """A front-door ``substrate='local'`` entry: the answer and the
    exploration counters."""
    keys = ("n_candidates", "m_candidates", "rounds", "nodes_touched", "edges_scanned",
            "frontier_exhausted")
    return record(best_alive, best_density, best_size, passes,
                  **{k: info[k] for k in keys}, bucket=[int(b) for b in info["bucket"]],
                  candidates_sha256=array_sha256(np.asarray(info["candidates"], np.int64)))


def reference_serve_entry(case: str) -> list:
    """One serve entry, computed by the JAX package."""
    import dataclasses

    from repro.core import Problem, solve
    from repro.graph.edgelist import to_csr
    from repro.serve.densest import DensestQueryEngine

    kind, name = case.rsplit(".", 1)
    edges = make_graph(name)
    seeds = serve_seeds(to_csr(edges)[0])
    prob = Problem.undirected(**SERVE_PROBLEM)
    if kind == "local":
        out = []
        for s in seeds[:SERVE_FRONT_DOOR]:
            res = solve(edges, dataclasses.replace(prob, substrate="local"), seed=s)
            out.append(local_record(res.best_alive, res.best_density, res.best_size,
                                    res.passes, res.extras["local"]))
        return out
    eng = DensestQueryEngine(edges, prob, extraction=kind.split(".")[1], **SERVE_ENGINE)
    return [query_record(r) for r in eng.query_many(seeds)]


def port_serve_entry(case: str, device) -> list:
    """The port's answer for one serve case on ``device``, in the
    fixture's form."""
    import dataclasses

    from repro_torch.core import Problem, solve
    from repro_torch.graph import generators
    from repro_torch.graph.edgelist import to_csr
    from repro_torch.serve import DensestQueryEngine

    kind, name = case.rsplit(".", 1)
    gen, kw = GRAPHS[name]
    out = getattr(generators, gen)(**kw, device=device)
    edges = out[0] if isinstance(out, tuple) else out
    seeds = serve_seeds(to_csr(edges)[0])
    prob = Problem.undirected(**SERVE_PROBLEM)
    if kind == "local":
        out = []
        for s in seeds[:SERVE_FRONT_DOOR]:
            res = solve(edges, dataclasses.replace(prob, substrate="local"), seed=s)
            out.append(local_record(res.best_alive.cpu().numpy(),
                                    res.best_density.cpu().numpy(), res.best_size.cpu(),
                                    res.passes, res.extras["local"]))
        return out
    eng = DensestQueryEngine(edges, prob, extraction=kind.split(".")[1], **SERVE_ENGINE)
    return [query_record(r) for r in eng.query_many(seeds)]


# -- the LM entries ----------------------------------------------------------

LM_ARCH = "llama3.2-3b"
LM_SEED = 0
# Tolerance of the prefill logits, float32 compute: f32 reassociation.
LM_LOGITS_TOL = 2e-5
LM_CASES = {
    "dense": dict(window=None, prompt_lens=(5, 9, 7), max_new=4, n_slots=2, max_len=64),
    "window16": dict(window=16, prompt_lens=(40, 9), max_new=6, n_slots=2, max_len=64),
}


def lm_params(cfg) -> dict:
    """The port's ``param_spec`` drawn by ``numpy.random.default_rng(LM_SEED)``
    in its key order (a truncated normal by redrawing values past 2 std):
    the same float32 arrays for the JAX package and for the port."""
    from repro_torch.models.transformer import param_spec

    rng = np.random.default_rng(LM_SEED)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        shape, init = node
        if init in ("ones", "zeros"):
            return (np.ones if init == "ones" else np.zeros)(shape, np.float32)
        kind, std = init
        x = rng.standard_normal(shape)
        if kind == "trunc":
            out = np.abs(x) > 2
            while out.any():
                x[out] = rng.standard_normal(int(out.sum()))
                out = np.abs(x) > 2
        return (x * std).astype(np.float32)

    return draw(param_spec(cfg))


def lm_prompts(case: dict) -> list:
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n, dtype=np.int32) for n in case["prompt_lens"]]


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def lm_record(prefill_logits, tokens, margins) -> dict:
    return {
        "prefill_logits": [[float(x) for x in np.asarray(lg, np.float32)] for lg in prefill_logits],
        "tokens": [[int(t) for t in toks] for toks in tokens],
        "margins": [[float(m) for m in ms] for ms in margins],
    }


def reference_lm_entry(case_name: str) -> dict:
    """One LM entry, computed by the JAX package."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models.transformer import forward, prefill
    from repro.serve.engine import Request, ServeEngine
    from repro_torch.configs import get_arch as port_arch

    case = LM_CASES[case_name]
    base = dataclasses.replace(get_arch(LM_ARCH).reduced_config, remat=False,
                               compute_dtype=jnp.float32, window=case["window"])
    params = jax.tree.map(jnp.asarray, lm_params(port_arch(LM_ARCH).reduced_config))
    prompts = lm_prompts(case)
    pallas = dataclasses.replace(base, attn_impl="pallas")
    pre = [prefill(params, pallas, jnp.asarray(p)[None])[0][0] for p in prompts]
    eng = ServeEngine(params, base, n_slots=case["n_slots"], max_len=case["max_len"])
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=case["max_new"]))
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    margins = []
    for p, r in zip(prompts, done):
        seq = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        logits = np.asarray(forward(params, base, jnp.asarray(seq)[None])[0][0])
        margins.append([_margin(logits[len(p) - 1 + j]) for j in range(len(r.tokens))])
    return lm_record(pre, [r.tokens for r in done], margins)


def port_lm_entry(case_name: str, device) -> dict:
    """The port's answer for one LM case on ``device``, in the fixture's
    form (margins from the port's own forward)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import forward, params_from_reference, prefill
    from repro_torch.serve.engine import Request, ServeEngine

    case = LM_CASES[case_name]
    base = dataclasses.replace(get_arch(LM_ARCH).reduced_config, remat=False,
                               compute_dtype=torch.float32, window=case["window"])
    params = params_from_reference(lm_params(base), base, device)
    prompts = lm_prompts(case)
    pallas = dataclasses.replace(base, attn_impl="pallas")
    pre = [prefill(params, pallas, torch.as_tensor(p, device=device)[None])[0][0].cpu()
           for p in prompts]
    eng = ServeEngine(params, base, n_slots=case["n_slots"], max_len=case["max_len"],
                      device=device)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=case["max_new"]))
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    margins = []
    for p, r in zip(prompts, done):
        seq = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        logits = forward(params, base, torch.as_tensor(seq, device=device)[None])[0][0].cpu()
        margins.append([_margin(logits[len(p) - 1 + j].numpy()) for j in range(len(r.tokens))])
    return lm_record(pre, [r.tokens for r in done], margins)


def lm_mismatch(got: dict, want: dict, tol: float = LM_LOGITS_TOL):
    """None if ``got`` meets ``want`` (tokens equal, prefill logits and
    margins within ``tol``), else a message naming the first difference."""
    if got["tokens"] != want["tokens"]:
        return f"tokens {got['tokens']} != {want['tokens']}"
    for key in ("prefill_logits", "margins"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            g, w = np.asarray(g), np.asarray(w)
            err = np.abs(g - w) - tol * (1 + np.abs(w))
            if g.shape != w.shape or (err > 0).any():
                return f"{key}[{i}]: max abs err {np.abs(g - w).max()} past rtol=atol={tol}"
    return None


# -- the MoE LM entries (REDUCED mixtral-8x7b and llama4, float32 compute) ----

LM_MOE_ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
LM_MOE_CASE = dict(forward_shape=(2, 64), prompt_lens=(16, 48), max_new=6, n_slots=2,
                   max_len=64)


def lm_moe_tokens() -> np.ndarray:
    """The forward batch: 2 x 64 tokens, two MoE groups of the REDUCED
    configs' 64, at their own capacity (tokens drop)."""
    return np.random.default_rng(2).integers(0, 512, LM_MOE_CASE["forward_shape"],
                                             dtype=np.int32)


def lm_moe_record(logits, moe_loss, drop_fracs, prefill_logits, tokens, margins) -> dict:
    """``lm_record`` plus the forward's digest: each row's last-position
    logits and each position's largest logit (within the logits' tolerance
    whenever every logit is), the summed ``moe_aux + moe_z`` and each
    layer's ``moe_drop_frac``."""
    logits = np.asarray(logits, np.float32)
    rec = lm_record(prefill_logits, tokens, margins)
    rec.update({
        "forward_last_logits": [[float(x) for x in row[-1]] for row in logits],
        "forward_row_max": [[float(x) for x in row.max(-1)] for row in logits],
        "moe_loss": float(moe_loss),
        "moe_drop_frac": [float(d) for d in drop_fracs],
    })
    return rec


def reference_lm_moe_entry(arch: str) -> dict:
    """One MoE entry, computed by the JAX package: the forward batch (and its
    layers one by one, whose ``_ffn_block`` returns the MoE aux), prefill
    under pallas, the engine's greedy chain and its margins."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.models.transformer import _attention_block, _ffn_block, forward, prefill
    from repro.serve.engine import Request, ServeEngine
    from repro_torch.configs import get_arch as port_arch

    case = LM_MOE_CASE
    base = dataclasses.replace(get_arch(arch).reduced_config, remat=False,
                               compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, lm_params(port_arch(arch).reduced_config))
    toks = jnp.asarray(lm_moe_tokens())
    logits, moe_loss = forward(params, base, toks)
    x = jnp.take(params["embed"]["w"], toks, axis=0).astype(base.compute_dtype)
    positions = jnp.arange(toks.shape[1], dtype=jnp.int32)
    drops = []
    for i in range(base.n_layers):
        p = jax.tree.map(lambda a: a[i], params["layers"])
        x, _, _ = _attention_block(base, p, x, positions)
        x, aux = _ffn_block(base, p, x)
        drops.append(aux["moe_drop_frac"])
    prompts = lm_prompts(case)
    pallas = dataclasses.replace(base, attn_impl="pallas")
    pre = [prefill(params, pallas, jnp.asarray(p)[None])[0][0] for p in prompts]
    eng = ServeEngine(params, base, n_slots=case["n_slots"], max_len=case["max_len"])
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=case["max_new"]))
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    margins = []
    for p, r in zip(prompts, done):
        seq = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        lg = np.asarray(forward(params, base, jnp.asarray(seq)[None])[0][0])
        margins.append([_margin(lg[len(p) - 1 + j]) for j in range(len(r.tokens))])
    return lm_moe_record(logits, moe_loss, drops, pre, [r.tokens for r in done], margins)


def port_lm_moe_entry(arch: str, device) -> dict:
    """The port's answer for one MoE entry on ``device``, in the fixture's
    form (margins from the port's own forward)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    case = LM_MOE_CASE
    base = dataclasses.replace(get_arch(arch).reduced_config, remat=False,
                               compute_dtype=torch.float32)
    params = tf.params_from_reference(lm_params(base), base, device)
    toks = torch.as_tensor(lm_moe_tokens(), device=device)
    logits, moe_loss = tf.forward(params, base, toks)
    drops = []
    with torch.inference_mode():
        x = tf._embed(base, params, toks)
        positions = torch.arange(toks.shape[1], dtype=torch.int32, device=device)
        for i in range(base.n_layers):
            p = tf.layer_params(params, i)
            x, _, _ = tf._attention_block(base, p, x, positions)
            x, aux = tf._ffn_block(base, p, x)
            drops.append(aux["moe_drop_frac"].item())
    prompts = lm_prompts(case)
    pallas = dataclasses.replace(base, attn_impl="pallas")
    pre = [tf.prefill(params, pallas, torch.as_tensor(p, device=device)[None])[0][0].cpu()
           for p in prompts]
    eng = ServeEngine(params, base, n_slots=case["n_slots"], max_len=case["max_len"],
                      device=device)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new=case["max_new"]))
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    margins = []
    for p, r in zip(prompts, done):
        seq = np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)])
        lg = tf.forward(params, base, torch.as_tensor(seq, device=device)[None])[0][0].cpu()
        margins.append([_margin(lg[len(p) - 1 + j].numpy()) for j in range(len(r.tokens))])
    return lm_moe_record(logits.cpu(), moe_loss.item(), drops, pre, [r.tokens for r in done],
                         margins)


def lm_moe_mismatch(got: dict, want: dict, tol: float = LM_LOGITS_TOL):
    """None if ``got`` meets ``want``: :func:`lm_mismatch`, the forward's
    digest and ``moe_loss`` within ``tol``, each layer's drop share equal."""
    bad = lm_mismatch(got, want, tol)
    if bad is not None:
        return bad
    if got["moe_drop_frac"] != want["moe_drop_frac"]:
        return f"moe_drop_frac {got['moe_drop_frac']} != {want['moe_drop_frac']}"
    for key in ("forward_last_logits", "forward_row_max", "moe_loss"):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if g.shape != w.shape or (np.abs(g - w) > tol * (1 + np.abs(w))).any():
            return f"{key}: max abs err {np.abs(g - w).max()} past rtol=atol={tol}"
    return None


def compute() -> dict:
    return {
        "eps": EPS,
        "graphs": {name: {"generator": gen, "kwargs": kw} for name, (gen, kw) in GRAPHS.items()},
        "answers": {
            name: {cell: reference_entry(name, cell) for cell in CELLS} for name in GRAPHS
        },
        "objectives": {
            "at_least_k": {name: k for name, k in AT_LEAST_K.items()},
            "directed": {"generator": DIRECTED_GRAPH[0], "kwargs": DIRECTED_GRAPH[1],
                         "c": DIRECTED_C},
            "sweep_eps": list(SWEEP_EPS),
            "answers": {case: reference_objective_entry(case) for case in OBJECTIVE_CASES},
        },
        "streaming": {
            "cases": STREAM_CASES,
            "answers": {case: reference_stream_entry(case) for case in STREAM_CASES},
        },
        "mesh": {
            "devices": MESH_DEVICES,
            "cases": MESH_CASES,
            "answers": reference_mesh_entries(),
        },
        "serve": {
            "problem": SERVE_PROBLEM, "engine": SERVE_ENGINE, "queries": SERVE_QUERIES,
            "front_door": SERVE_FRONT_DOOR,
            "answers": {case: reference_serve_entry(case) for case in SERVE_CASES},
        },
        "lm": {
            "arch": LM_ARCH, "seed": LM_SEED,
            "cases": {name: {**case, "prompt_lens": list(case["prompt_lens"])}
                      for name, case in LM_CASES.items()},
            "answers": {name: reference_lm_entry(name) for name in LM_CASES},
        },
        "lm_moe": {
            "seed": LM_SEED,
            "case": {**LM_MOE_CASE, "forward_shape": list(LM_MOE_CASE["forward_shape"]),
                     "prompt_lens": list(LM_MOE_CASE["prompt_lens"])},
            "answers": {arch: reference_lm_moe_entry(arch) for arch in LM_MOE_ARCHS},
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
    print(json.dumps(golden["objectives"]["answers"], indent=1, sort_keys=True))
    print(json.dumps(golden["streaming"]["answers"], indent=1, sort_keys=True))
    print(json.dumps(golden["mesh"]["answers"], indent=1, sort_keys=True))
    for case, entry in golden["serve"]["answers"].items():
        print(case, [(e.get("seed"), e.get("size", e.get("best_size"))) for e in entry])
    for name, entry in golden["lm"]["answers"].items():
        print(name, "tokens", entry["tokens"], "least margin",
              min(min(m) for m in entry["margins"]))
    for arch, entry in golden["lm_moe"]["answers"].items():
        print(arch, "tokens", entry["tokens"], "moe_loss", entry["moe_loss"],
              "drop", entry["moe_drop_frac"], "least margin",
              min(min(m) for m in entry["margins"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
