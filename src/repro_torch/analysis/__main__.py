"""The port's contract linter from the command line (counterpart of
``scripts/analyze.py``, with its flags and output)::

    PYTHONPATH=src python -m repro_torch.analysis              # lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --strict     # the gate
    PYTHONPATH=src python -m repro_torch.analysis --list-rules
    PYTHONPATH=src python -m repro_torch.analysis path/to/file.py   # fixture mode

Paths given as FILES are analyzed unscoped: every rule runs, wherever the
file lies.  Directories are walked scoped.

Exit status: 0 when clean; 1 when any finding (``--strict``) or any
error-severity finding (default) survives suppression.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import Project, all_rules, analyze_paths, render_finding
from repro_torch.analysis.project import _repo_root

_DEFAULT_TARGETS = ("src/repro_torch",)


def main(argv=None) -> int:
    root_default = _repo_root()
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="the port's contract linter")
    ap.add_argument("paths", nargs="*",
                    help="files (analyzed unscoped: all rules) and/or directories "
                         "(walked scoped); default: src/repro_torch")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on ANY finding, warnings included (the gate)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id + summary and exit")
    ap.add_argument("--root", default=root_default,
                    help="repo root anchoring relative paths (default: this repo)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, summary in all_rules().items():
            print(f"{rid:20s} {summary}")
        return 0

    project = Project.load(args.root if args.root != root_default else None)
    targets = args.paths or [os.path.join(args.root, t) for t in _DEFAULT_TARGETS]
    findings = []
    for t in targets:
        ap_t = os.path.abspath(t)
        findings.extend(analyze_paths([ap_t], root=args.root, project=project,
                                      scoped=os.path.isdir(ap_t)))
    for f in findings:
        print(render_finding(f))
    gating = [f for f in findings if args.strict or f.severity == "error"]
    n = len(findings)
    print(f"analyze: {n} finding{'s' if n != 1 else ''}"
          + (f" ({len(gating)} gating)" if n else ""))
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
