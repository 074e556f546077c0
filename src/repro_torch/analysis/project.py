"""Static views of the port's contract surfaces (counterpart of
``repro.analysis.project``).

The rules need two facts about the port: its registered fault sites
(``src/repro_torch/faults.py::KNOWN_SITES``) and its named capacity
constants (``src/repro_torch/constants.py``).  Both are PARSED from source,
never imported, so the linter sees the tree as committed.  The reference's
third surface, the cache-key classification of ``Problem`` fields, has no
counterpart: the port caches no traced programs, and its ``api.py`` has no
``_FIELD_CLASS``.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Optional, Tuple

__all__ = ["Project"]

_FAULTS_REL = "src/repro_torch/faults.py"
_CONSTANTS_REL = "src/repro_torch/constants.py"


def _repo_root() -> str:
    # src/repro_torch/analysis/project.py -> the repo root is three levels up.
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def _parse(path: str) -> Optional[ast.Module]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        try:
            return ast.parse(f.read())
        except SyntaxError:
            return None


def _module_assign(tree: Optional[ast.Module], name: str) -> Optional[ast.expr]:
    if tree is None:
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node.value
    return None


class Project:
    """Lazily parsed contract surfaces, shared across the analyzed files.

    ``Project.load()`` anchors at the repo this package lives in (the CLI's
    and the fixture tests' case: fixtures trip the rules against the port's
    real registries); ``Project.load(root)`` reads another tree."""

    _DEFAULT: Optional["Project"] = None

    def __init__(self, root: str):
        self.root = root
        self._known_sites: Optional[Tuple[str, ...]] = None
        self._constants: Optional[Dict[str, int]] = None

    @classmethod
    def load(cls, root: Optional[str] = None) -> "Project":
        if root is not None:
            return cls(os.path.abspath(root))
        if cls._DEFAULT is None:
            cls._DEFAULT = cls(_repo_root())
        return cls._DEFAULT

    @property
    def known_sites(self) -> Tuple[str, ...]:
        """``faults.KNOWN_SITES`` parsed from source (empty if absent)."""
        if self._known_sites is None:
            val = _module_assign(_parse(os.path.join(self.root, _FAULTS_REL)), "KNOWN_SITES")
            sites = []
            if isinstance(val, (ast.Tuple, ast.List)):
                sites = [el.value for el in val.elts
                         if isinstance(el, ast.Constant) and isinstance(el.value, str)]
            self._known_sites = tuple(sites)
        return self._known_sites

    @property
    def capacity_constants(self) -> Dict[str, int]:
        """Module-level integer constants of ``constants.py``."""
        if self._constants is None:
            tree = _parse(os.path.join(self.root, _CONSTANTS_REL))
            out: Dict[str, int] = {}
            for node in tree.body if tree is not None else ():
                if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, int)):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = node.value.value
            self._constants = out
        return self._constants
