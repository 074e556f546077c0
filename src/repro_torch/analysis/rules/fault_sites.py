"""fault-sites: the port's fault-injection surface is a closed registry
(counterpart of ``repro.analysis.rules.fault_sites``).

Contract: fault plans steer injection by SITE NAME, so the set of names is
an API and ``src/repro_torch/faults.py::KNOWN_SITES`` is its registry.  Two
failure shapes this rule closes off:

  * a ``faults.fire("typo.site")`` call whose name is not registered: a
    plan aimed at the registry would never hit it;
  * an except-wrapped IO path in the modules bound by the failure contract
    (streaming, the cache of built kernels, the turnstile runtime, the
    memmap store and spill writer, serving, checkpoints) WITHOUT a hook:
    recovery code the fault tests cannot reach.

The second check is structural: a ``try`` whose body performs file IO and
that catches exceptions must also call ``faults.fire(...)`` inside its body
(the hook sits before the IO it makes injectable).
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Finding, Rule, SourceFile, dotted, register

# The reference's failure-contract modules, in the port (check 2 applies
# only here when walking the tree; fixture files are checked everywhere).
_FAILURE_SCOPES = (
    "src/repro_torch/core/streaming.py",
    "src/repro_torch/core/progcache.py",
    "src/repro_torch/core/turnstile.py",
    "src/repro_torch/graph/edgelist.py",
    "src/repro_torch/serve/",
    "src/repro_torch/checkpoint/",
)

_IO_CALLS = frozenset({
    "open", "io.open", "os.fdopen", "os.replace", "os.rename", "os.fsync", "os.makedirs",
    "atomic_write_file", "np.load", "np.save", "np.savez", "pickle.load", "pickle.loads",
    "pickle.dump", "pickle.dumps", "json.load", "json.dump", "shutil.rmtree",
})


def _is_fire(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    return name is not None and (name == "fire" or name.endswith(".fire"))


def _does_io(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if name is None:
        return False
    return name in _IO_CALLS or name.rsplit(".", 1)[-1] in ("atomic_write_file",
                                                            "atomic_publish")


@register
class FaultSitesRule(Rule):
    id = "fault-sites"
    summary = (
        "fire() sites come from faults.KNOWN_SITES, and every except-wrapped "
        "IO path in the failure-contract modules carries an injection hook"
    )

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        known = set(project.known_sites)
        for node in ast.walk(sf.tree):
            if _is_fire(node) and node.args:
                site = node.args[0]
                if (isinstance(site, ast.Constant) and isinstance(site.value, str)
                        and site.value not in known):
                    yield self.finding(
                        sf, node,
                        f"fire() site {site.value!r} is not registered in faults.KNOWN_SITES",
                        hint="add it to src/repro_torch/faults.py's KNOWN_SITES",
                    )
            if isinstance(node, ast.Try) and node.handlers and sf.in_scope(*_FAILURE_SCOPES):
                body = [n for stmt in node.body for n in ast.walk(stmt)]
                if any(_does_io(n) for n in body) and not any(_is_fire(n) for n in body):
                    yield self.finding(
                        sf, node,
                        "except-wrapped IO path without a faults.fire() hook: this recovery "
                        "branch is unreachable by the fault tests",
                        hint="call faults.fire('<module>.<site>') at the top of the try body "
                             "(and register the site)",
                    )
