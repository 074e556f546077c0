"""Trips atomic-io: every raw-write shape the rule closes off (a built
library published with a bare rename, a raw checkpoint write)."""

import os
import pathlib


def publish_library(tmp: str, path: str, blob: bytes) -> None:
    with open(tmp, "wb") as f:  # raw write-mode open (finding)
        f.write(blob)
    os.replace(tmp, path)  # raw publish outside ioutil (finding)


def log_line(path: str, line: str) -> None:
    with open(path, mode="a") as f:  # append is write-capable too (finding)
        f.write(line)


def flush_hard(f) -> None:
    f.flush()
    os.fsync(f.fileno())  # durability outside ioutil (finding)


def sidecar(path: str, text: str) -> None:
    pathlib.Path(path).write_text(text)  # bypasses the primitive (finding)
