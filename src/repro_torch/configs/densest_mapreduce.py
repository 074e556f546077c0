"""The paper's own workload as an 'architecture' (counterpart of
``repro.configs.densest_mapreduce``): distributed Algorithm 1 over
edge-sharded graphs at the paper's experimental scales (Table 1).

The shapes size the port's benchmarks (``--shape flickr_sm``) and
``chip_smoke.py``'s graphs.  The dry-run cell (``launch/cells.py``) traces
one full peel with edges sharded over every mesh axis and O(n) node state
on every device, one pass body times its trip count."""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.configs.base import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DensestConfig:
    name: str = "densest-mapreduce"
    eps: float = 0.5
    max_passes: int = 64


CONFIG = DensestConfig()
REDUCED = dataclasses.replace(CONFIG, max_passes=16)

SHAPES: Mapping[str, ShapeSpec] = {
    # FLICKR-scale (Table 1): 976K nodes, 7.6M edges.
    "flickr_sm": ShapeSpec(
        "flickr_sm", "peel", dict(n_nodes=976_000, n_edges=7_600_000)
    ),
    # LIVEJOURNAL-scale: 4.84M nodes, 68.9M edges.
    "livejournal_md": ShapeSpec(
        "livejournal_md", "peel", dict(n_nodes=4_840_000, n_edges=68_900_000)
    ),
    # TWITTER-scale: 50.7M nodes, 2.7B edges.
    "twitter_lg": ShapeSpec(
        "twitter_lg", "peel", dict(n_nodes=50_700_000, n_edges=2_700_000_000)
    ),
    # IM-scale: 645M nodes, 6.1B edges: Count-Sketch node state (t=5, b=2^17)
    # since the exact O(n) degree vector would be 2.6 GB replicated.
    "im_xl": ShapeSpec(
        "im_xl",
        "peel_sketched",
        dict(n_nodes=645_000_000, n_edges=6_100_000_000, t=5, b=1 << 17),
    ),
}

SPEC = ArchSpec(
    arch_id="densest-mapreduce",
    family="densest",
    config=CONFIG,
    reduced_config=REDUCED,
    param_rules=[],
    shapes=SHAPES,
    notes="the paper's own workload; edges sharded over all mesh axes",
)


def chung_lu_args(shape: str, exponent: float = 2.2, seed: int = 0) -> dict:
    """``chung_lu_power_law`` arguments for a peel shape: its node count and
    the average degree that draws its edge count (before deduplication)."""
    p = SHAPES[shape].params
    return dict(n=p["n_nodes"], exponent=exponent,
                avg_deg=2 * p["n_edges"] / p["n_nodes"], seed=seed)
