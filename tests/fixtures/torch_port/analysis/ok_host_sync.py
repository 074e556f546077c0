"""Zero findings: counted reads, and tensor methods that are not reads."""

import numpy as np

from repro_torch import hostsync


def keep_going(going) -> bool:
    return bool(hostsync.read(going))


def best_nodes(best_alive) -> np.ndarray:
    return np.nonzero(hostsync.fetch(best_alive))[0]


def on_device(x, device):
    return x.to(device).float().sum()
