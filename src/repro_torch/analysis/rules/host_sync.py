"""host-sync: every device-to-host read on a solve path is counted
(the port's counterpart of ``repro.analysis.rules.tracer_hygiene``).

The reference's contract is that traced code never round-trips through the
host.  The port traces nothing: it runs eagerly, and its host loops read
the device on purpose (the peel loop's continuation test, the ladder's
survivor counts).  What it must keep is the count: every such read goes
through :func:`repro_torch.hostsync.read` or :func:`repro_torch.hostsync.fetch`,
so ``hostsync.read.count``, which ``chip_smoke.py`` and the benchmarks
report as a solve's host syncs, is the truth.

The checker flags, in the solve path's modules (``core/engine.py``,
``core/api.py``, ``core/mapreduce.py``), a call of ``.item()``,
``.tolist()``, ``.cpu()`` or ``.numpy()``: one finding a read, so
``x.cpu().numpy()`` is one.  A read of data that already lives on the host
(a CPU tensor such as a ``DeviceMesh``'s layout) carries a justified
``# repro: allow(host-sync) <why it is host data>``.  ``int()``,
``float()`` and ``numpy.asarray`` of a tensor also sync and are not
decided here: the names alone do not say whether the value is a tensor.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Finding, Rule, SourceFile, register

_SOLVE_PATH = (
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/api.py",
    "src/repro_torch/core/mapreduce.py",
)
_READS = ("item", "tolist", "cpu", "numpy")


def _read_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _READS)


@register
class HostSyncRule(Rule):
    id = "host-sync"
    summary = (
        "device-to-host reads on a solve path (core/engine.py, api.py, mapreduce.py) go "
        "through hostsync.read/fetch, so read.count counts every host sync"
    )

    def applies(self, rel: str) -> bool:
        return rel in _SOLVE_PATH

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        calls = [n for n in ast.walk(sf.tree) if _read_call(n)]
        # x.cpu().numpy(): the inner call is the outer one's receiver, one read.
        inner = {id(n.func.value) for n in calls}
        for node in calls:
            if id(node) in inner:
                continue
            yield self.finding(
                sf, node,
                f".{node.func.attr}() reads a tensor to the host outside hostsync: the "
                "read is not counted in hostsync.read.count",
                hint="read card tensors with repro_torch.hostsync.read (a scalar or list) "
                     "or hostsync.fetch (a numpy array); host data carries "
                     "# repro: allow(host-sync) <why it is host data>",
            )
