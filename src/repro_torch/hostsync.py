"""Device-to-host reads of the port, counted.

Every scalar the host loop needs from the device (the peel loop's
continuation test, the ladder's survivor counts, a rung's chunk count)
goes through :func:`read` (an array through :func:`fetch`), so
``read.count`` is the number of host syncs a solve made.  ``chip_smoke.py`` resets and reports it.
"""

from __future__ import annotations

import torch


def read(x: torch.Tensor):
    """``x.tolist()`` (a Python scalar for a 0-dim tensor): one
    device-to-host sync when ``x`` is on the card."""
    read.count += 1
    return x.tolist()


read.count = 0


def fetch(x: torch.Tensor):
    """``x`` as a numpy array on the host, counted in ``read.count`` like
    :func:`read` (one device-to-host copy when ``x`` is on the card)."""
    read.count += 1
    return x.cpu().numpy()
