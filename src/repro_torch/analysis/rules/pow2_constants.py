"""pow2-constants: bucket floors and capacities come from constants.py
(counterpart of ``repro.analysis.rules.pow2_constants``).

Contract: a padded capacity is snapped to a power of two above a FLOOR, and
the port lands on the reference's bucket shapes and ladder schedule for the
same graph because both read one set of floors (the parity tests compare
compaction segments one to one).  A re-typed literal floor
(``pow2_bucket(n, 64)``) forks the constant: the day ``constants.py`` is
tuned, the forked site keeps the old value.

The checker flags, outside ``src/repro_torch/constants.py``:

  * a literal int passed as the ``floor``/``stride`` argument of
    ``pow2_bucket``/``ladder_schedule`` (pass ``constants.X`` or a module
    alias ``_X = constants.X``);
  * a module-level assignment of a capacity-suffixed name (``*_FLOOR``,
    ``*_MIN_EDGES``, ``*_MIN_NODES``, ``*_MAX_SEGMENTS``, ``*_STRIDE``) to a
    literal int: alias the constants surface instead (aliases stay
    patchable in tests; the value has one home).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import PORT_PREFIX, Finding, Rule, SourceFile, dotted, register

_CONSTANTS_REL = "src/repro_torch/constants.py"
_CAPACITY_SUFFIXES = ("_FLOOR", "_MIN_EDGES", "_MIN_NODES", "_MAX_SEGMENTS", "_STRIDE")
# callable name -> (positional index, keyword name) of its capacity args
_CAPACITY_ARGS = {
    "pow2_bucket": ((1, "floor"),),
    "ladder_schedule": ((1, "floor"), (2, "stride")),
}


def _literal_int(node: Optional[ast.expr]) -> Optional[int]:
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return node.value
    return None


@register
class Pow2ConstantsRule(Rule):
    id = "pow2-constants"
    summary = (
        "pow2 bucket floors / ladder capacities come from constants.py "
        "(no literal floors at call sites, no re-typed capacity constants)"
    )

    def applies(self, rel: str) -> bool:
        return rel.startswith(PORT_PREFIX) and rel != _CONSTANTS_REL

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        surface = ", ".join(sorted(project.capacity_constants)) or "(none)"
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            base = name.rsplit(".", 1)[-1] if name else None
            for pos, kw in _CAPACITY_ARGS.get(base, ()):
                arg = node.args[pos] if len(node.args) > pos else None
                for k in node.keywords:
                    if k.arg == kw:
                        arg = k.value
                val = _literal_int(arg)
                if val is not None:
                    yield self.finding(
                        sf, arg,
                        f"literal {kw}={val} passed to {base}(): the capacity is forked "
                        "from the constants surface",
                        hint=f"pass a repro_torch.constants name (surface: {surface})",
                    )
        for node in sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            val = _literal_int(node.value)
            if val is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id.upper().endswith(_CAPACITY_SUFFIXES):
                    yield self.finding(
                        sf, node,
                        f"capacity constant {t.id} = {val} re-typed outside the constants "
                        "surface",
                        hint=f"alias it: {t.id} = constants.<NAME> (add the value to "
                             f"{_CONSTANTS_REL} if it is new)",
                    )
