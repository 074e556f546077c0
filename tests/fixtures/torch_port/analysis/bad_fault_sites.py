"""Trips fault-sites: an unregistered site name and a hook-less IO try."""

import json

from repro_torch import faults


def publish(path: str, payload: dict) -> bool:
    faults.fire("progcache.stroe")  # typo'd site name (finding)
    return True


def load(path: str):
    try:  # except-wrapped IO with no fire() hook (finding)
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None
