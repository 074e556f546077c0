"""Trips host-sync: device-to-host reads that hostsync.read.count misses."""

import numpy as np


def keep_going(going) -> bool:
    return bool(going.item())  # uncounted scalar read (finding)


def survivors(counts) -> list:
    return counts.tolist()  # uncounted list read (finding)


def best_nodes(best_alive) -> np.ndarray:
    return np.nonzero(best_alive.cpu().numpy())[0]  # one read, one finding


def as_host(x):
    return x.numpy()  # (finding)


def to_host(x):
    return x.cpu()  # (finding)
