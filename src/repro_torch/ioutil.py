"""Shared host-I/O primitive of the port (counterpart of ``repro.ioutil``,
copied: the port imports nothing of the JAX package).

The crash-safe file publish behind the persistent cache of built kernels
(``core/progcache.py``), the streaming driver's checkpoints
(``core/streaming.py``) and the spill ladder's manifests
(``graph/edgelist.py``).
"""

from __future__ import annotations

import os
import tempfile
from typing import IO, Callable


def atomic_write_file(
    final_path: str,
    write_fn: Callable[[IO], None],
    mode: str = "wb",
    suffix: str = ".tmp",
) -> None:
    """Crash-safe publish: ``write_fn(f)`` into a same-directory temp file,
    flush + fsync, then ``os.replace`` onto ``final_path``: a reader sees
    the old content or the new, never a torn write.  The temp file is
    removed on failure."""
    d = os.path.dirname(final_path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
