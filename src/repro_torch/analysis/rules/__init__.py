"""The port's checkers.  Importing this package registers every rule; each
module's docstring states the contract it encodes and names its reference
counterpart (docs/port.md has the table)."""

from repro_torch.analysis.rules import (  # noqa: F401  (registration imports)
    atomic_io,
    fault_sites,
    host_sync,
    pow2_constants,
    single_engine,
)
