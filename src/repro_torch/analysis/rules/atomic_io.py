"""atomic-io: persistent artifacts are published through ioutil.py
(counterpart of ``repro.analysis.rules.atomic_io``).

Contract: anything a later process may READ BACK (checkpoints, built
kernel libraries and their sidecars, spill manifests) is written with the
temp file + fsync + ``os.replace`` sequence that
``src/repro_torch/ioutil.py`` owns, so a crash at any byte leaves the old
artifact or the new one, never a torn hybrid.  The fault tests only prove
crash safety for writes routed through that module.

The checker flags, outside ``src/repro_torch/ioutil.py``:

  * ``open``/``os.fdopen`` with a write-capable constant mode
    (``w``/``a``/``x``/``+``);
  * ``os.replace`` / ``os.rename`` (the publish step);
  * ``os.fsync`` (durability);
  * ``Path.write_text`` / ``Path.write_bytes``.

Deliberate exceptions (append-only data files whose manifest is published
last, the quarantine of a corrupt file) carry the reference's
``# repro: allow(atomic-io) <why this write is already crash-safe>``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import PORT_PREFIX, Finding, Rule, SourceFile, dotted, register

_IOUTIL_REL = "src/repro_torch/ioutil.py"
_HINT = (
    "publish through repro_torch.ioutil (atomic_write_file, atomic_publish: "
    "temp file + fsync + os.replace) so a crash leaves the old artifact or the new one"
)


def _write_mode(call: ast.Call) -> Optional[str]:
    """The constant mode string of an open()-style call iff write-capable."""
    mode_node: Optional[ast.expr] = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if not (isinstance(mode_node, ast.Constant) and isinstance(mode_node.value, str)):
        return None
    mode = mode_node.value
    return mode if any(c in mode for c in "wax+") else None


@register
class AtomicIoRule(Rule):
    id = "atomic-io"
    summary = (
        "persistent artifacts are written only through ioutil.py "
        "(no raw write-mode open/os.replace/fsync in the port)"
    )

    def applies(self, rel: str) -> bool:
        return rel.startswith(PORT_PREFIX) and rel != _IOUTIL_REL

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in ("open", "io.open", "os.fdopen"):
                mode = _write_mode(node)
                if mode is not None:
                    yield self.finding(
                        sf, node, f"raw {name}(..., {mode!r}) write of a persistent artifact",
                        hint=_HINT)
            elif name in ("os.replace", "os.rename"):
                yield self.finding(
                    sf, node, f"{name} outside ioutil: the atomic publish step is ioutil's job",
                    hint=_HINT)
            elif name == "os.fsync":
                yield self.finding(
                    sf, node, "os.fsync outside ioutil: durability is ioutil's job", hint=_HINT)
            elif isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "write_text", "write_bytes"):
                yield self.finding(
                    sf, node, f"Path.{node.func.attr} bypasses the atomic-publish primitive",
                    hint=_HINT)
