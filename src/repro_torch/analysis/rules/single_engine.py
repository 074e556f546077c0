"""single-engine: the peel threshold exists once, in core/engine.py
(counterpart of ``repro.analysis.rules.single_engine``).

Contract: the paper's removal threshold ``2(1+eps)·rho`` is computed by
:func:`repro_torch.core.engine.removal_threshold` and nowhere else.  Every
wrapper (streaming driver, mesh ladder, turnstile maintenance, serving)
calls the engine; none re-derives the expression, or the copies drift the
day one of them is tuned.

The checker flags, outside ``src/repro_torch/core/engine.py``:

  * the expression ``2 * (1 + <eps>)`` (any numeric spelling, either
    operand order, any name containing ``eps``);
  * a function definition named ``removal_threshold``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import PORT_PREFIX, Finding, Rule, SourceFile, dotted, register

_ENGINE_REL = "src/repro_torch/core/engine.py"


def _is_const(node: ast.AST, value: float) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
        and float(node.value) == value
    )


def _mentions_eps(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        name = dotted(sub)
        if name is not None and "eps" in name.rsplit(".", 1)[-1].lower():
            return True
    return False


def _is_one_plus_eps(node: ast.AST) -> bool:
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
        return False
    left, right = node.left, node.right
    return (_is_const(left, 1.0) and _mentions_eps(right)) or (
        _is_const(right, 1.0) and _mentions_eps(left))


def _is_threshold_expr(node: ast.AST) -> bool:
    """``2 * (1 + eps)`` in either operand order."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult)):
        return False
    left, right = node.left, node.right
    return (_is_const(left, 2.0) and _is_one_plus_eps(right)) or (
        _is_const(right, 2.0) and _is_one_plus_eps(left))


@register
class SingleEngineRule(Rule):
    id = "single-engine"
    summary = (
        "the 2(1+eps)·rho removal threshold is computed only by "
        "core/engine.py:removal_threshold (no re-derived peel thresholds)"
    )

    def applies(self, rel: str) -> bool:
        return rel.startswith(PORT_PREFIX) and rel != _ENGINE_REL

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if _is_threshold_expr(node):
                yield self.finding(
                    sf, node, "re-derived peel threshold `2 * (1 + eps)` outside the engine",
                    hint="call repro_torch.core.engine.removal_threshold(eps, rho): the "
                         "expression exists once, in " + _ENGINE_REL,
                )
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.name == "removal_threshold"):
                yield self.finding(
                    sf, node, "shadow definition of removal_threshold outside the engine",
                    hint="import it: from repro_torch.core.engine import removal_threshold",
                )
