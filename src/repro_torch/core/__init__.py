"""The port's core: the front door (api.py) over the peel engine
(engine.py), the §5.1 Count-Sketch backend (countsketch.py), the turnstile
runtime (turnstile.py), the local substrate's exploration (local.py), the
semi-streaming driver (streaming.py), the §5.2 mesh substrate
(mapreduce.py), the cache of built kernels (progcache.py) and the numpy
baselines (exact.py, charikar.py).  The names match ``repro.core``'s for every ported part.

    from repro_torch.core import Problem, solve, solve_batch
    res = solve(edges, Problem.undirected(eps=0.5, backend="pallas"))
    res = solve(edges, Problem.at_least_k(k=100))
    res = solve(edges, Problem.directed())           # the c grid
    sweep = solve_batch(edges, Problem.undirected(), eps=[0.25, 0.5, 1.0])
    res = solve(edges, Problem(substrate="local"), seed=17)
    res = solve(edges, Problem(substrate="streaming"), checkpoint_dir="ck")
    res = solve(edges, Problem(substrate="mesh"), mesh=make_mesh((1,), ("data",)))
"""

from repro_torch.core.api import (
    DenseSubgraphResult,
    Problem,
    Provenance,
    Solver,
    default_solver,
    run_cell,
    solve,
    solve_batch,
    stack_graphs,
)
from repro_torch.core.charikar import charikar_greedy
from repro_torch.core.countsketch import (
    SketchBackend,
    densest_subgraph_sketched,
    make_sketch_params,
    query_degrees,
    sketch_degrees_from_edges,
    sketch_endpoint_counters,
    sketched_degree_fn,
)
from repro_torch.core.density import density_of, max_passes_bound, undirected_stats
from repro_torch.core.engine import (
    AtLeastKFraction,
    DirectedST,
    ExactBackend,
    FnBackend,
    MeshSegmentSumBackend,
    PeelOutcome,
    PeelState,
    UndirectedThreshold,
    removal_threshold,
    run_peel,
    segment_degree_count,
    undirected_pass_step,
)
from repro_torch.core.local import LocalExploration, LocalExplorer
from repro_torch.core.exact import (
    densest_directed_brute,
    densest_subgraph_brute,
    densest_subgraph_exact,
)
from repro_torch.core.mapreduce import (
    densest_subgraph_distributed,
    make_distributed_directed_peel,
    make_distributed_peel,
    make_distributed_peel_compacted,
    make_distributed_peel_ladder,
    make_mesh,
    shard_edges,
)
from repro_torch.core.peel import densest_subgraph, densest_subgraph_sets
from repro_torch.core.peel_directed import (
    c_grid,
    densest_directed_search,
    densest_directed_search_vmapped,
    densest_subgraph_directed,
)
from repro_torch.core.peel_topk import densest_subgraph_at_least_k
from repro_torch.core.streaming import (
    StreamingDensest,
    chunked_from_arrays,
    chunked_from_memmap,
)
from repro_torch.core.turnstile import TurnstileDensest, TurnstileSketch

__all__ = [
    "AtLeastKFraction",
    "DenseSubgraphResult",
    "DirectedST",
    "ExactBackend",
    "FnBackend",
    "LocalExploration",
    "LocalExplorer",
    "MeshSegmentSumBackend",
    "PeelOutcome",
    "PeelState",
    "Problem",
    "Provenance",
    "SketchBackend",
    "Solver",
    "StreamingDensest",
    "TurnstileDensest",
    "TurnstileSketch",
    "UndirectedThreshold",
    "c_grid",
    "charikar_greedy",
    "chunked_from_arrays",
    "chunked_from_memmap",
    "default_solver",
    "densest_directed_brute",
    "densest_directed_search",
    "densest_directed_search_vmapped",
    "densest_subgraph",
    "densest_subgraph_at_least_k",
    "densest_subgraph_brute",
    "densest_subgraph_directed",
    "densest_subgraph_distributed",
    "densest_subgraph_exact",
    "densest_subgraph_sets",
    "densest_subgraph_sketched",
    "density_of",
    "make_distributed_directed_peel",
    "make_distributed_peel",
    "make_distributed_peel_compacted",
    "make_distributed_peel_ladder",
    "make_mesh",
    "make_sketch_params",
    "max_passes_bound",
    "query_degrees",
    "removal_threshold",
    "run_cell",
    "run_peel",
    "segment_degree_count",
    "shard_edges",
    "sketch_degrees_from_edges",
    "sketch_endpoint_counters",
    "sketched_degree_fn",
    "solve",
    "solve_batch",
    "stack_graphs",
    "undirected_pass_step",
    "undirected_stats",
]
