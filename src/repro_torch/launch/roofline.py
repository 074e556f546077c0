"""Roofline terms of a traced dry-run step (counterpart of
``repro.launch.roofline``), against a chip's published rates:

    compute_s    = FLOPs a device          / peak dense bf16 FLOP/s
    memory_s     = HBM bytes a device      / HBM bytes/s
    collective_s = wire bytes within a node / NVLink bytes/s
                 + wire bytes across nodes  / network bytes/s (per GPU)

The quantities come from ``op_stats`` on the local shards, so they are
per device and the device count cancels (``op_stats.RANKS_PER_NODE``
ranks share a node: 8, an HGX H100 board).  The chip is a parameter
(:class:`ChipSpec`); the default is one NVIDIA H100 SXM5 80GB in an
8-GPU node.  These are predictions from published rates, not
measurements: a card may run below its 700 W power limit, and a record
names the chip its constants describe.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float  # dense, FLOP/s
    hbm_bw: float  # bytes/s
    hbm_bytes: float  # bytes of device memory
    nvlink_bw: float  # bytes/s a GPU, one direction, within a node
    net_bw: float  # bytes/s a GPU, one direction, across nodes
    source: str


# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column:
H100_SXM = ChipSpec(
    name="NVIDIA H100 SXM5 80GB",
    peak_flops_bf16=989e12,  # "BF16 Tensor Core 1,979 TFLOPS" with sparsity; dense half
    hbm_bw=3.35e12,  # "GPU memory bandwidth 3.35TB/s" (HBM3)
    hbm_bytes=80e9,  # "GPU memory 80GB"
    nvlink_bw=450e9,  # "NVLink 900GB/s" (both directions) -> 450 GB/s each way
    net_bw=50e9,  # one 400 Gb/s ConnectX-7 NDR port a GPU (DGX H100 / HGX H100 nodes)
    source="NVIDIA H100 Tensor Core GPU data sheet (SXM5), dense rates; "
           "400 Gb/s InfiniBand NDR a GPU across nodes",
)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device quantities from op_stats
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    # analytic
    model_flops_total: float
    peak_memory_per_dev: Optional[float] = None
    by_collective: Optional[Dict[str, float]] = None
    # wire bytes a device that stay inside a node (the rest cross nodes)
    coll_bytes_intra_node: float = 0.0
    chip: ChipSpec = H100_SXM
    notes: str = ""

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.chip.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        intra = min(self.coll_bytes_intra_node, self.coll_bytes_per_dev)
        return intra / self.chip.nvlink_bw + (self.coll_bytes_per_dev - intra) / self.chip.net_bw

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The roofline: perfect overlap of the three terms (their max)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def model_flops_ratio(self) -> float:
        """useful / counted compute (catches remat and padding waste)."""
        hw = self.flops_per_dev * self.n_devices
        return self.model_flops_total / hw if hw else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(useful model FLOPs / devices / peak) / step time."""
        if self.step_time_s == 0:
            return 0.0
        useful_s = self.model_flops_total / self.n_devices / self.chip.peak_flops_bf16
        return useful_s / self.step_time_s

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            bound=self.bound,
            step_time_s=self.step_time_s,
            model_flops_ratio=self.model_flops_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def from_stats(
    arch: str,
    shape: str,
    mesh: str,
    n_devices: int,
    stats: Dict[str, Any],
    model_flops: float,
    peak_memory: Optional[float] = None,
    chip: ChipSpec = H100_SXM,
    notes: str = "",
) -> Roofline:
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh,
        n_devices=n_devices,
        flops_per_dev=stats["flops"],
        hbm_bytes_per_dev=stats["hbm_bytes"],
        coll_bytes_per_dev=stats["collective_bytes"],
        model_flops_total=model_flops,
        peak_memory_per_dev=peak_memory,
        by_collective=stats.get("by_collective"),
        coll_bytes_intra_node=stats.get("collective_bytes_intra_node", 0.0),
        chip=chip,
        notes=notes,
    )


def fmt_row(r: Roofline) -> str:
    return (
        f"| {r.arch} | {r.shape} | {r.mesh} | "
        f"{r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} | {r.collective_s*1e3:.2f} | "
        f"{r.bound} | {r.model_flops_ratio:.2f} | {r.roofline_fraction:.2%} |"
    )
