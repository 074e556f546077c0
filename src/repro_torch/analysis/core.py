"""Visitor core of the port's contract linter: findings, rules, suppressions
(counterpart of ``repro.analysis.core``, copied: the port imports nothing
of the JAX package, not even its jax-free linter).

The model:

  * a :class:`Rule` is one contract checker: a stable ``id``, a severity,
    a path scope (:meth:`Rule.applies`, inside ``src/repro_torch/``) and a
    :meth:`Rule.check` that yields :class:`Finding`s from a parsed
    :class:`SourceFile`;
  * the registry (:data:`RULES`, filled by the :func:`register` decorator
    when ``repro_torch.analysis.rules`` is imported) is the one list of rule
    ids; docs/port.md's rule table names the same ids;
  * inline suppressions use the reference's grammar, ``# repro:
    allow(<rule>) <justification>``: trailing a line it covers that line,
    on a line of its own it covers the next line.  The runner
    (:func:`analyze_file`) applies them, then lints the suppressions
    themselves: a missing justification or an unknown rule id is a
    ``bad-suppression`` finding (and does NOT suppress), a suppression that
    matched nothing is ``unused-suppression``.

The reference's linter scopes its rules to ``src/repro/`` and never reads
the port, so the port's lines carry the same comments as the reference's
without either linter reading the other's.  Pure ``ast``/``tokenize``: no
torch on this path.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "META_RULES",
    "PORT_PREFIX",
    "RULES",
    "Finding",
    "Rule",
    "SourceFile",
    "Suppression",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "dotted",
    "register",
    "render_finding",
]

# Every rule's scope when the tree is walked: the port's package.
PORT_PREFIX = "src/repro_torch/"


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: file:line anchor, rule id, message, fix-it hint."""

    rule: str
    path: str  # repo-relative (or as given): the display path
    line: int
    col: int
    message: str
    hint: str = ""
    severity: str = "error"  # "error" | "warn"


def render_finding(f: Finding) -> str:
    out = f"{f.path}:{f.line}:{f.col}: [{f.rule}] {f.severity}: {f.message}"
    if f.hint:
        out += f"\n    hint: {f.hint}"
    return out


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

# Rules the runner itself emits: listed with the checkers, no checker class,
# and never suppressible (the linter lints its own exemption mechanism).
META_RULES = {
    "bad-suppression": (
        "a `# repro: allow(...)` comment must name a known rule and carry "
        "a justification"
    ),
    "unused-suppression": (
        "a `# repro: allow(...)` comment that suppresses nothing must be "
        "removed (stale exemptions hide future violations)"
    ),
}

_ALLOW_PREFIX = "repro:"
_ALLOW_KEYWORD = "allow("


@dataclasses.dataclass
class Suppression:
    """One parsed ``# repro: allow(rule[, rule...]) justification``."""

    rules: Tuple[str, ...]
    justification: str
    comment_line: int  # where the comment sits
    covers_line: int  # the line findings are matched against
    col: int
    used: bool = False
    malformed: str = ""  # non-empty -> bad-suppression message


def _parse_suppressions(text: str) -> List[Suppression]:
    """Comments only (tokenize): the allow() syntax inside a string literal
    is inert."""
    sups: List[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return sups
    lines = text.splitlines()
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        body = tok.string.lstrip("#").strip()
        if not body.startswith(_ALLOW_PREFIX):
            continue
        body = body[len(_ALLOW_PREFIX):].strip()
        line, col = tok.start
        standalone = lines[line - 1][:col].strip() == ""
        covers = line + 1 if standalone else line
        if not body.startswith(_ALLOW_KEYWORD) or ")" not in body:
            sups.append(Suppression(
                rules=(), justification="", comment_line=line, covers_line=covers, col=col,
                malformed="malformed suppression: expected "
                          "`# repro: allow(<rule>) <justification>`",
            ))
            continue
        inside, _, rest = body[len(_ALLOW_KEYWORD):].partition(")")
        rules = tuple(r.strip() for r in inside.split(",") if r.strip())
        sups.append(Suppression(rules=rules, justification=rest.strip(), comment_line=line,
                                covers_line=covers, col=col))
    return sups


# ---------------------------------------------------------------------------
# Source model
# ---------------------------------------------------------------------------


class SourceFile:
    """One parsed file: text, AST, suppressions, and its scope flag.

    ``scoped`` is True when the file was reached by walking a tree (each
    rule applies its own path scope) and False when it was given explicitly
    (fixture mode: every rule checks it, wherever it lies)."""

    def __init__(self, path: str, rel: str, text: str, scoped: bool = True):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.scoped = scoped
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:  # surfaced as a finding by the runner
            self.parse_error = e
        self.suppressions = _parse_suppressions(text)

    @classmethod
    def read(cls, path: str, rel: Optional[str] = None, scoped: bool = True):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return cls(path, rel if rel is not None else path, text, scoped)

    def in_scope(self, *prefixes: str) -> bool:
        """True when this file is inside one of ``prefixes``, or when it is
        checked unscoped (fixture mode)."""
        if not self.scoped:
            return True
        return any(
            self.rel == p or self.rel.startswith(p.rstrip("/") + "/") for p in prefixes
        )


# ---------------------------------------------------------------------------
# Rules + registry
# ---------------------------------------------------------------------------


class Rule:
    """Base checker.  Subclasses set ``id``/``summary`` and implement
    :meth:`check`; :meth:`applies` scopes the rule to the port's paths whose
    contract it encodes (bypassed in fixture mode)."""

    id: str = ""
    summary: str = ""  # one line: the CLI's rule list and docs/port.md
    severity: str = "error"

    def applies(self, rel: str) -> bool:
        return rel.startswith(PORT_PREFIX)

    def check(self, sf: SourceFile, project) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, node: ast.AST, message: str, hint: str = "") -> Finding:
        return Finding(
            rule=self.id, path=sf.rel, line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0), message=message, hint=hint,
            severity=self.severity,
        )


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiates and registers a Rule by its id."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"{cls.__name__} has no rule id")
    if inst.id in RULES or inst.id in META_RULES:
        raise ValueError(f"duplicate rule id {inst.id!r}")
    RULES[inst.id] = inst
    return cls


def all_rules() -> Dict[str, str]:
    """Every known rule id -> one-line summary (checkers, then meta rules)."""
    out = {rid: r.summary for rid, r in sorted(RULES.items())}
    out.update(sorted(META_RULES.items()))
    return out


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _meta(sf: SourceFile, sup: Suppression, rule: str, message: str, hint: str) -> Finding:
    return Finding(rule, sf.rel, sup.comment_line, sup.col, message, hint=hint)


def _meta_findings(sf: SourceFile) -> List[Finding]:
    out: List[Finding] = []
    known = set(RULES) | set(META_RULES)
    grammar = "# repro: allow(<rule>) <justification>"
    for sup in sf.suppressions:
        if sup.malformed:
            out.append(_meta(sf, sup, "bad-suppression", sup.malformed, grammar))
            continue
        bad = False
        for rid in sup.rules:
            if rid in META_RULES:
                out.append(_meta(sf, sup, "bad-suppression",
                                 f"meta rule {rid!r} cannot be suppressed",
                                 "fix or remove the underlying suppression"))
                bad = True
            elif rid not in known:
                out.append(_meta(sf, sup, "bad-suppression",
                                 f"unknown rule {rid!r} in suppression",
                                 f"known rules: {', '.join(sorted(known))}"))
                bad = True
        if not sup.rules:
            out.append(_meta(sf, sup, "bad-suppression", "suppression names no rule", grammar))
            bad = True
        if not sup.justification:
            out.append(_meta(sf, sup, "bad-suppression", "suppression has no justification",
                             f"say WHY the violation is deliberate: {grammar}"))
            bad = True
        if not bad and not sup.used:
            out.append(_meta(sf, sup, "unused-suppression",
                             f"suppression for {', '.join(sup.rules)} matched no finding",
                             "remove it (stale exemptions hide future violations)"))
    return out


def _valid(sup: Suppression) -> bool:
    """Only well-formed, justified suppressions suppress."""
    return (
        not sup.malformed
        and bool(sup.rules)
        and bool(sup.justification)
        and not any(r in META_RULES for r in sup.rules)
    )


def analyze_file(
    path: str,
    rel: Optional[str] = None,
    rules: Optional[Sequence[Rule]] = None,
    project=None,
    scoped: bool = True,
) -> List[Finding]:
    """Runs the rule set over one file, applies suppressions, lints them."""
    from repro_torch.analysis.project import Project

    sf = SourceFile.read(path, rel=rel, scoped=scoped)
    if sf.parse_error is not None:
        e = sf.parse_error
        return [Finding("syntax-error", sf.rel, e.lineno or 1, e.offset or 0,
                        f"file does not parse: {e.msg}")]
    if project is None:
        project = Project.load()
    active = list(rules) if rules is not None else list(RULES.values())
    raw: List[Finding] = []
    for rule in active:
        if scoped and not rule.applies(sf.rel):
            continue
        raw.extend(rule.check(sf, project))
    kept: List[Finding] = []
    for f in raw:
        sup = next((s for s in sf.suppressions
                    if _valid(s) and s.covers_line == f.line and f.rule in s.rules), None)
        if sup is not None:
            sup.used = True
        else:
            kept.append(f)
    kept.extend(_meta_findings(sf))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def _walk_py(root_path: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root_path):
        dirnames[:] = sorted(d for d in dirnames if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def analyze_paths(
    paths: Iterable[str],
    root: Optional[str] = None,
    rules: Optional[Sequence[Rule]] = None,
    project=None,
    scoped: bool = True,
) -> List[Finding]:
    """Analyzes files and/or directory trees.  ``root`` anchors the
    repo-relative display paths (default: cwd), which the rules' scopes
    read; listed FILES are always analyzed, directories are walked for
    ``*.py``."""
    root = os.path.abspath(root or os.getcwd())
    out: List[Finding] = []
    for p in paths:
        ap = os.path.abspath(p if os.path.isabs(p) else os.path.join(root, p))
        targets = [ap] if os.path.isfile(ap) else list(_walk_py(ap))
        for t in targets:
            out.extend(analyze_file(t, rel=os.path.relpath(t, root), rules=rules,
                                    project=project, scoped=scoped))
    return out
