"""The one multiply-shift hash family of the port (counterpart of
``repro.kernels.hashing``), spelled in torch.

Count-Sketch (§5.1) hashes node ids and the ℓ0 sampler of the turnstile
runtime hashes edge id pairs with the same wrap-around multiply-shift mix:
odd uint32 multiplier, uint32 offset, mod-2^32 arithmetic, xorshift
finalizer.  The CUDA kernels inline the same four functions from
``kernels/csrc/hashing.cuh`` on native ``uint32_t``.

PyTorch has no uint32 add, shift, modulo or compare on the CPU, so a uint32
value is held in an int64 tensor in ``[0, 2^32)``.  Every multiply and add
is masked back to 32 bits with ``& 0xFFFFFFFF``.  A product of two values
below 2^32 can pass 2^63 and wrap mod 2^64; the wrap keeps the low 32 bits,
which are all the mask keeps.  After the mask every value is non-negative,
so ``>>`` is a logical shift.
"""

from __future__ import annotations

import torch

__all__ = [
    "AVALANCHE", "MASK32", "as_u32", "bucket32", "level_from_hash", "mix32", "mix32_pair",
    "sign32", "to_i32",
]

# Odd avalanche multiplier of the pair mix's second round.
AVALANCHE = 0x7FEB352D
MASK32 = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor holding the uint32 bit pattern of ``x`` (an int32 id
    array, or already-widened values)."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the low 32 bits of the int64 ``x`` (its value mod
    2^32, read as two's complement): the reference's uint32-to-int32
    bitcast and its int32 wrap-around sums, without signed overflow."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def mix32(a, c, x: torch.Tensor) -> torch.Tensor:
    """``h = a*x + c`` (mod 2^32), xorshift-finalized.  ``a`` must be odd.
    Operands are uint32 values held in int64 (tensors or Python ints)."""
    h = (a * x + c) & MASK32
    return h ^ (h >> 16)


def bucket32(h: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """int32 bucket index from a mixed uint32 (the Count-Sketch column)."""
    return (h % n_buckets).to(torch.int32)


def sign32(h: torch.Tensor) -> torch.Tensor:
    """±1.0 float32 sign from a mixed uint32's top bit."""
    return torch.where((h >> 31) == 0, 1.0, -1.0).to(torch.float32)


def mix32_pair(a_x, a_y, c, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``h = a_x*x + a_y*y + c`` (mod 2^32), then xorshift, odd avalanche
    multiply, xorshift: the ℓ0 sampler's edge hash.  Both multipliers odd."""
    h = (a_x * x + a_y * y + c) & MASK32
    h = h ^ (h >> 16)
    h = (h * AVALANCHE) & MASK32
    return h ^ (h >> 15)


def level_from_hash(h: torch.Tensor, n_levels: int) -> torch.Tensor:
    """int32 geometric level ``min(clz32(h), L-1)`` of a mixed uint32: the
    number of thresholds ``2^(31-r)``, ``r < L-1``, that ``h`` lies below —
    the reference's compare-based sum, term for term (a threshold below 1,
    for ``r > 31``, counts nothing there either)."""
    lvl = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    for r in range(min(n_levels - 1, 32)):
        lvl += (h < (1 << (31 - r))).to(torch.int32)
    return lvl
