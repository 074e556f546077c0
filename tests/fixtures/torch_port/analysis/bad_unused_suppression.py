"""Trips unused-suppression: a well-formed exemption matching no finding."""


def harmless(x: int) -> int:
    # repro: allow(host-sync) stale: the read this guarded was deleted (finding)
    return x + 1
