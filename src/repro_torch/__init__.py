"""PyTorch/CUDA port of the densest-subgraph peeling system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``graph/``, ``core/``, ``kernels/``) and names so a module's counterpart is
easy to find.  It imports ``torch`` and numpy only.  Importing it loads
nothing heavy: kernels are built and loaded at first launch.

    from repro_torch.core import Problem, solve
    from repro_torch.graph.generators import planted_dense_subgraph
    edges, planted = planted_dense_subgraph(2000, 4, 60, 0.6, seed=7)  # on cuda
    res = solve(edges, Problem.undirected(eps=0.5, backend="pallas"))
"""

__version__ = "1.0.0"
