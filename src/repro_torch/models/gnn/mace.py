"""MACE, higher-order equivariant message passing (arXiv:2206.07697),
counterpart of ``repro.models.gnn.mace``: explicit real spherical harmonics
to l_max=2, a Bessel radial basis, the density-normalized A-basis by
segment sum, and a symmetric tensor-power B-basis of invariant monomials up
to correlation order 3 with learned couplings.  The invariant readout is
exactly SO(3)-invariant (property-tested under random rotations).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.graph.edgelist import Device, resolve_device
from repro_torch.models.common import (
    dense,
    dense_init,
    gather,
    l2_loss,
    mlp,
    mlp_init,
    segment_sum,
    silu,
    softmax_cross_entropy,
    tree_from_reference,
)


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    d_in: int = 16  # species/feature embedding input
    n_classes: int = 0
    compute_dtype: torch.dtype = torch.bfloat16


MACE_PARAM_RULES = [
    (r".*(radial|update|readout|embed).*/w", ("fsdp", "tp")),
    (r".*/b", (None,)),
    (r".*coupling", (None, "tp")),
]

N_SH = 9  # (l_max+1)^2 for l_max=2
L_OF = (0, 1, 1, 1, 2, 2, 2, 2, 2)  # l of each flat SH index
N_INV = 8  # invariant monomials (see _invariants)


def spherical_harmonics_l2(rhat: torch.Tensor) -> torch.Tensor:
    """Real SH Y_lm for l=0,1,2 of unit vectors rhat [E,3] -> [E,9]."""
    x, y, z = rhat[:, 0], rhat[:, 1], rhat[:, 2]
    c0 = 0.28209479177387814
    c1 = 0.4886025119029199
    return torch.stack(
        [
            torch.full_like(x, c0),
            c1 * y,
            c1 * z,
            c1 * x,
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.31539156525252005 * (3.0 * z * z - 1.0),
            1.0925484305920792 * x * z,
            0.5462742152960396 * (x * x - y * y),
        ],
        dim=-1,
    )


def bessel_basis(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    """Radial Bessel basis with a smooth cutoff envelope; r [E] -> [E, n]."""
    r = r.clamp_min(1e-6)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=r.device) * math.pi / r_cut
    basis = math.sqrt(2.0 / r_cut) * torch.sin(k * r[:, None]) / r[:, None]
    u = (r / r_cut).clamp(0.0, 1.0)
    envelope = 1.0 - 10.0 * u**3 + 15.0 * u**4 - 6.0 * u**5
    return basis * envelope[:, None]


def init_params(cfg: MACEConfig, generator: torch.Generator, device: Device = None):
    """f32 parameters drawn from ``generator`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    c = cfg.d_hidden
    n_l = cfg.l_max + 1
    with torch.no_grad():
        params = {"embed": {"layer0": dense_init(generator, cfg.d_in, c, bias=True,
                                                 device=dev)}}
        for i in range(cfg.n_layers):
            coupling = torch.empty((N_INV * c, c), device=dev)
            params[f"layer{i}"] = {
                "radial": mlp_init(generator, [cfg.n_rbf, 64, n_l * c], device=dev),
                "coupling": coupling.normal_(0.0, 1.0, generator=generator).mul_(0.1),
                "update": mlp_init(generator, [c, c, c], device=dev),
            }
        out_d = cfg.n_classes if cfg.n_classes > 0 else 1
        params["readout"] = mlp_init(generator, [c, c, out_d], device=dev)
    return params


def params_from_reference(tree, cfg: MACEConfig, device: Device = None):
    """The reference's parameter tree (numpy arrays) as f32 tensors on
    ``device`` (default: the card)."""
    like = init_params(cfg, torch.Generator(), "meta")
    return tree_from_reference(tree, like, resolve_device(device))


def _invariants(A: torch.Tensor) -> torch.Tensor:
    """Invariant monomials of the A-basis up to correlation order 3.

    A: [N, 9, C].  Per-l power spectra (order 2) and their products with the
    l=0 channel (order 3), all exactly SO(3)-invariant.
    """
    a0 = A[:, 0, :]  # l=0 (order 1)
    p1 = (A[:, 1:4, :] ** 2).sum(1)  # l=1 power (order 2)
    p2 = (A[:, 4:9, :] ** 2).sum(1)  # l=2 power (order 2)
    return torch.cat([a0, p1, p2, a0 * a0, a0 * p1, a0 * p2, a0 * a0 * a0, p1 * p2], dim=-1)


def forward(params, cfg: MACEConfig, batch):
    """batch = {features [N,F], positions [N,3], src, dst, edge_mask [E]}."""
    cd = cfg.compute_dtype
    h = dense(params["embed"]["layer0"], batch["features"].to(cd), cd)  # [N, C]
    x = batch["positions"].float()
    src, dst = batch["src"], batch["dst"]
    w = batch["edge_mask"].float()
    n, c = h.shape
    n_l = cfg.l_max + 1
    l_of = torch.tensor(L_OF, device=h.device)

    rij = gather(x, dst) - gather(x, src)
    # The 1e-12 keeps a masked self-loop's (rij = 0) norm, and its gradient,
    # finite.
    r = torch.linalg.vector_norm(rij + 1e-12, dim=-1)
    rhat = rij / (r[:, None] + 1e-12)
    Y = spherical_harmonics_l2(rhat) * w[:, None]  # [E, 9]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut)  # [E, n_rbf]

    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        R = mlp(p["radial"], rbf.to(cd), act=silu, compute_dtype=cd)
        R = R.reshape(-1, n_l, c)  # [E, n_l, C]
        R_per_sh = R.index_select(1, l_of)  # [E, 9, C]
        hj = gather(h, src)  # [E, C]
        msg = R_per_sh * Y[:, :, None].to(cd) * hj[:, None, :]  # [E, 9, C]
        A = segment_sum(msg, dst, n)  # [N, 9, C]
        inv = _invariants(A.float()).to(cd)  # [N, 8C]
        b_basis = inv @ p["coupling"].to(cd)  # [N, C]
        h = h + mlp(p["update"], b_basis, act=silu, compute_dtype=cd)
    return h


def loss_energy(params, cfg: MACEConfig, batch):
    h = forward(params, cfg, batch)
    e_node = mlp(params["readout"], h, act=silu, compute_dtype=cfg.compute_dtype)
    e = segment_sum(e_node[:, 0].float(), batch["graph_ids"], batch["graph_labels"].shape[0])
    return l2_loss(e, batch["graph_labels"])


def loss_node_class(params, cfg: MACEConfig, batch):
    h = forward(params, cfg, batch)
    logits = mlp(params["readout"], h, act=silu, compute_dtype=cfg.compute_dtype)
    return softmax_cross_entropy(logits.float(), batch["labels"], batch.get("train_mask"))
