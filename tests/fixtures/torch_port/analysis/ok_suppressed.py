"""Zero findings: real violations, each under a justified suppression."""

import os


def publish(tmp: str, final: str) -> None:
    # repro: allow(atomic-io) fixture pin: standalone comment covers the next line
    os.replace(tmp, final)


def layout_rows(mesh) -> list:
    return mesh.mesh.tolist()  # repro: allow(host-sync) fixture pin: a mesh layout is a CPU tensor
