"""Trips pow2-constants: literal floors at call sites and a re-typed alias."""

from repro_torch.graph.partition import ladder_schedule, pow2_bucket

CHUNK_FLOOR = 1024  # re-typed capacity constant (finding)


def pad_plan(n_alive: int, m0: int):
    n_pad = pow2_bucket(n_alive, 64)  # literal positional floor (finding)
    cap = pow2_bucket(n_alive, floor=256)  # literal keyword floor (finding)
    rungs = ladder_schedule(m0, floor=4096, stride=4)  # both literal (2 findings)
    return n_pad, cap, rungs
