"""repro_torch.analysis: the port's contract linter (counterpart of
``repro.analysis``, copied and scoped to ``src/repro_torch/``).

The port rests on the reference's written contracts: the removal threshold
exists only in ``core/engine.py::removal_threshold``, persistent artifacts
are published only through ``ioutil.py``, every failure-prone IO site
threads a ``faults.fire()`` hook from ``faults.KNOWN_SITES``, pow2 floors
and capacities live in ``constants.py``; and one of its own: every
device-to-host read on a solve path goes through ``hostsync``, so the host
sync count the port reports is the truth.  Each rule encodes one of them as
an AST check (docs/port.md has the rule table beside the reference's).

Front door::

    PYTHONPATH=src python -m repro_torch.analysis [--strict] [paths...]

or programmatically::

    from repro_torch.analysis import analyze_paths
    findings = analyze_paths(["src/repro_torch"], root=REPO)

Suppressions use the reference's grammar, ``# repro: allow(<rule>)
<justification>``, and are linted too.  Pure ``ast``/stdlib: this package
imports neither torch nor anything of ``repro``.
"""

from repro_torch.analysis.core import (
    META_RULES,
    RULES,
    Finding,
    Rule,
    SourceFile,
    Suppression,
    all_rules,
    analyze_file,
    analyze_paths,
    register,
    render_finding,
)
from repro_torch.analysis.project import Project

# Importing the rules package registers every checker.
from repro_torch.analysis import rules as _rules  # noqa: F401,E402  (registration)

__all__ = [
    "META_RULES",
    "RULES",
    "Finding",
    "Project",
    "Rule",
    "SourceFile",
    "Suppression",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "register",
    "render_finding",
]
