"""The port's contract linter (``repro_torch.analysis``), mirroring
tests/test_analysis.py:

  * the port's tree is clean: ``analyze_paths(["src/repro_torch"])`` returns
    no finding, and ``python -m repro_torch.analysis --strict`` exits 0;
  * the rules work: every known-bad fixture in
    tests/fixtures/torch_port/analysis/ trips exactly the rules its name
    promises, with pinned counts, the ok_* fixtures stay silent, and every
    registered rule is tripped by a fixture;
  * the rules the port shares with the reference count alike: the port's
    rule and the reference's, each run on the same text at the path its
    linter scopes, report the same number of findings.
"""

import os
import shutil
import subprocess
import sys

import pytest

from repro.analysis import RULES as REF_RULES
from repro.analysis import Project as RefProject
from repro.analysis import analyze_paths as ref_analyze_paths
from repro_torch.analysis import (
    META_RULES,
    RULES,
    Project,
    all_rules,
    analyze_file,
    analyze_paths,
    render_finding,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_port", "analysis")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
SEVEN = ("single-engine", "atomic-io", "fault-sites", "pow2-constants", "host-sync",
         "bad-suppression", "unused-suppression")


def _counts(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def _fixture(name):
    return analyze_file(os.path.join(FIXTURES, name), rel=name, scoped=False)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO, env=ENV, timeout=120)


# --------------------------------------------------------------------------
# the port's tree is clean
# --------------------------------------------------------------------------


def test_port_tree_is_clean():
    findings = analyze_paths(["src/repro_torch"], root=REPO, project=Project.load(),
                             scoped=True)
    assert findings == [], "\n".join(render_finding(f) for f in findings)


def test_cli_strict_exits_zero():
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("analyze: 0 findings")


def test_cli_lists_every_rule():
    proc = _cli("--list-rules")
    assert proc.returncode == 0, proc.stderr
    listed = [line.split()[0] for line in proc.stdout.splitlines() if line.strip()]
    assert sorted(listed) == sorted(all_rules()) == sorted(SEVEN)


def test_cli_strict_fails_on_a_fixture():
    proc = _cli("--strict", os.path.join(FIXTURES, "bad_host_sync.py"))
    assert proc.returncode == 1
    assert "[host-sync]" in proc.stdout and "analyze: 5 findings" in proc.stdout


def test_project_reads_the_port_registries():
    project = Project.load()
    assert "progcache.store" in project.known_sites
    assert "streaming.checkpoint_load" in project.known_sites
    assert project.capacity_constants["K1_CHUNK_FLOOR"] == 1024
    assert project.capacity_constants["LADDER_MIN_EDGES"] == 4096


# --------------------------------------------------------------------------
# the fixture corpus trips every rule
# --------------------------------------------------------------------------

# fixture file -> exact {rule id: finding count}
CASES = {
    "bad_single_engine.py": {"single-engine": 3},
    "bad_atomic_io.py": {"atomic-io": 5},
    "bad_fault_sites.py": {"fault-sites": 2},
    "bad_pow2_constants.py": {"pow2-constants": 5},
    "bad_host_sync.py": {"host-sync": 5},
    "bad_unused_suppression.py": {"unused-suppression": 1},
    "bad_suppression.py": {"bad-suppression": 4, "atomic-io": 1},
    "ok_suppressed.py": {},
    "ok_strings_comments.py": {},
    "ok_host_sync.py": {},
}


@pytest.mark.parametrize("name,expected", sorted(CASES.items()))
def test_fixture(name, expected):
    findings = _fixture(name)
    assert _counts(findings) == expected, "\n".join(render_finding(f) for f in findings)


def test_every_rule_has_a_tripping_fixture():
    tripped = set()
    for name in CASES:
        tripped.update(f.rule for f in _fixture(name))
    assert set(RULES) | set(META_RULES) == tripped == set(SEVEN)


@pytest.mark.parametrize("name", sorted(n for n in CASES if n.startswith("bad_")))
def test_findings_carry_anchor_and_hint(name):
    for f in _fixture(name):
        assert f.line > 0 and f.hint, render_finding(f)
        assert name in render_finding(f)


def test_host_sync_anchors_one_finding_a_read():
    lines = [f.line for f in _fixture("bad_host_sync.py")]
    assert lines == [7, 11, 15, 19, 23]


# --------------------------------------------------------------------------
# acceptance: a raw checkpoint write put back into the port fails the gate
# --------------------------------------------------------------------------


def test_raw_checkpoint_write_in_a_copy_of_the_port_fails(tmp_path):
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "core" / "streaming.py"
    text = path.read_text()
    anchor = "        atomic_write_file(\n            path,\n            lambda f: np.savez("
    assert text.count(anchor) == 1
    raw = ("        with open(path + '.new', 'wb') as f:\n"
           "            np.savez(f, alive=st.alive)\n"
           "        os.replace(path + '.new', path)\n")
    path.write_text(text.replace(anchor, raw + anchor))
    findings = analyze_paths(["src/repro_torch"], root=str(tmp_path), project=Project.load(),
                             scoped=True)
    assert _counts(findings) == {"atomic-io": 2}
    start = text[:text.index(anchor)].count("\n") + 1
    assert sorted(f.line for f in findings) == [start, start + 2]
    assert all(f.path == "src/repro_torch/core/streaming.py" for f in findings)


def test_rules_are_scoped_to_the_port(tmp_path):
    """Walked scoped, a violation outside ``src/repro_torch/`` (the
    reference's tree among them) is not the port linter's business."""
    for pkg in ("repro", "elsewhere"):
        d = tmp_path / "src" / pkg
        d.mkdir(parents=True)
        (d / "ckpt.py").write_text("import os\nos.replace('a', 'b')\n")
    assert analyze_paths(["src"], root=str(tmp_path), scoped=True) == []


def test_unjustified_suppression_does_not_suppress(tmp_path):
    bad = tmp_path / "sneaky.py"
    bad.write_text("import os\n# repro: allow(atomic-io)\nos.replace('a', 'b')\n")
    got = _counts(analyze_file(str(bad), rel="sneaky.py", scoped=False))
    assert got == {"atomic-io": 1, "bad-suppression": 1}


def test_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    findings = analyze_file(str(bad), rel="broken.py", scoped=False)
    assert [f.rule for f in findings] == ["syntax-error"]


# --------------------------------------------------------------------------
# the shared rules count alike in both linters
# --------------------------------------------------------------------------

SHARED = {
    "single-engine": "bad_single_engine.py",
    "atomic-io": "bad_atomic_io.py",
    "fault-sites": "bad_fault_sites.py",
    "pow2-constants": "bad_pow2_constants.py",
}


@pytest.mark.parametrize("corpus", ["port", "reference"])
@pytest.mark.parametrize("rule", sorted(SHARED))
def test_shared_rule_counts_match_reference(tmp_path, rule, corpus):
    """One fixture text, written at ``src/repro/core/streaming.py`` for the
    reference's rule and at ``src/repro_torch/core/streaming.py`` for the
    port's (a module each linter scopes, fault-sites' IO check included)."""
    src_dir = FIXTURES if corpus == "port" else REF_FIXTURES
    with open(os.path.join(src_dir, SHARED[rule])) as f:
        text = f.read()
    counts = {}
    for pkg in ("repro", "repro_torch"):
        root = tmp_path / pkg
        path = root / "src" / pkg / "core" / "streaming.py"
        path.parent.mkdir(parents=True)
        path.write_text(text)
        if pkg == "repro":
            found = ref_analyze_paths([f"src/{pkg}"], root=str(root), rules=[REF_RULES[rule]],
                                      project=RefProject.load(), scoped=True)
        else:
            found = analyze_paths([f"src/{pkg}"], root=str(root), rules=[RULES[rule]],
                                  project=Project.load(), scoped=True)
        counts[pkg] = [f.line for f in found if f.rule == rule]
    assert counts["repro"] == counts["repro_torch"] and counts["repro"], counts
