"""Loops whose iterations all have the same shapes, countable the way the
reference's cost analysis counts a ``lax.scan``: its body once, times its
trip count.

``for x in uniform(items, n)`` is a plain loop, unless a tracer has turned
counting on (:func:`counting`, the dry-run's ``launch/cells.py``): then it
runs the first iteration only, with :func:`scale` multiplied by ``n`` while
that iteration runs, and the tracer charges each op ``scale()`` times.
Outputs a loop collects are padded back to ``n`` entries by :func:`fill`
(the first iteration's, repeated: the shapes are what a trace needs).
Nothing here changes a result outside a counting trace.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable, List


class _State(threading.local):
    def __init__(self):
        self.on = False
        self.scale = 1.0


_STATE = _State()


@contextlib.contextmanager
def counting():
    """Turns counting on for the block (see the module docstring)."""
    prev = _STATE.on
    _STATE.on = True
    try:
        yield
    finally:
        _STATE.on = prev


def scale() -> float:
    """How many times the op being dispatched now runs for real."""
    return _STATE.scale


def uniform(items: Iterable, n: int):
    """``items`` (``n`` of them, each iteration the same shapes), or under
    counting only the first, counted ``n`` times."""
    if not _STATE.on or n <= 1:
        yield from items
        return
    prev = _STATE.scale
    _STATE.scale = prev * n
    try:
        for item in items:
            yield item
            break
    finally:
        _STATE.scale = prev


def fill(items: List, n: int) -> List:
    """A loop's collected outputs padded to ``n`` by repeating the first
    (only under counting, where :func:`uniform` ran one iteration)."""
    if len(items) == n or not items:
        return items
    return items + [items[0]] * (n - len(items))
