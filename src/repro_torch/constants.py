"""Pow2 bucket floors and ladder capacities, one surface for the port.

The values are the JAX package's (``repro/constants.py``), copied so both
packages land on the same bucket shapes and the same ladder schedule for the
same graph: the parity tests compare their compaction segments one to one.
Modules alias these names (``_X = constants.X``) so tests can patch them.
The last section is the port's own: the reference has no counterpart.
"""

from __future__ import annotations

# Host (jit-substrate) geometric compaction ladder (core/api.py).
COMPACT_MIN_EDGES = 256
COMPACT_MIN_NODES = 128
COMPACT_MAX_SEGMENTS = 64

# Single-program mesh ladder.
LADDER_STRIDE = 4
LADDER_MIN_EDGES = 4096

# Streaming compaction rebuild.
STREAM_REBUILD_NODE_FLOOR = 64
STREAM_REBUILD_CHUNK_FLOOR = 256

# Serving ego-net buckets.
SERVE_NODE_FLOOR = 64
SERVE_EDGE_FLOOR = 256

# Local (Andersen) substrate.
LOCAL_BUDGET = 512
LOCAL_ROUNDS = 8
LOCAL_BUDGET_FLOOR = 64
LOCAL_VOLUME_FACTOR = 32

# Turnstile runtime.
TURNSTILE_SAMPLE_EDGE_FLOOR = 256
TURNSTILE_SAMPLE_NODE_FLOOR = 256
TURNSTILE_BATCH_FLOOR = 1024

# The port's own: K1's chunk plan (graph/partition.py::chunk_slots_for).  A
# chunk is at least one 128-slot step for each of a CTA's 8 warps.
K1_CHUNK_FLOOR = 1024
