"""Port parity: the examples of ``examples/torch_port/`` print the same
numbers as the reference's ``examples/`` at the same tiny arguments, on the
CPU.

``engine_matrix``'s (rho, |S|, passes) rows and ``directed_csweep``'s c
sweep (every c's rho and passes, the best c, the recovered sets) match
line for line; the quickstart's optimum, greedy, per-eps peels and sweep
match once the wall times are cut out; ``mapreduce_stream`` (the
reference's CI variant ``--n 6000``; the reference in a child process,
since it forces 8 host devices when imported) and ``turnstile_churn`` (the
reference's CI variant too) match on every density, ratio, pass count and
sample level.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, which: str, example: str, argv):
    if which == "port":
        mod = _load(REPO / "examples" / "torch_port" / f"{example}.py", f"port_ex_{example}")
        argv = argv + ["--device", "cpu"]
    else:
        mod = _load(REPO / "examples" / f"{example}.py", f"ref_ex_{example}")
    capsys.readouterr()
    if argv or which == "port":
        mod.main(argv)
    else:
        mod.main()
    return capsys.readouterr().out


def _cut(text: str, *patterns) -> str:
    for p in patterns:
        text = re.sub(p, "", text)
    return text


def test_engine_matrix_rows_match_reference(capsys):
    port = _run(capsys, "port", "engine_matrix", ["--n", "600"])
    ref = _run(capsys, "ref", "engine_matrix", ["--n", "600"])
    assert port == ref
    assert port.count("\n") >= 10


def test_directed_csweep_matches_reference(capsys):
    port = _run(capsys, "port", "directed_csweep", [])
    ref = _run(capsys, "ref", "directed_csweep", [])
    assert port == ref
    assert "<== best" in port


def test_quickstart_matches_reference(capsys):
    argv = ["--n", "2000", "--k", "50"]
    cut = (r" \(\d+\.\d+s\)", r" in one (program|peel loop)")
    port = _cut(_run(capsys, "port", "quickstart", argv), *cut)
    ref = _cut(_run(capsys, "ref", "quickstart", argv), *cut)
    assert port == ref
    assert "ratio=" in port and "solve_batch" in port


def _numbers(text: str):
    """(label, numbers) of each bracketed or indented result line."""
    out = []
    for line in text.splitlines():
        line = _cut(line, r"wall=\d+\.\d+s", r"query \d+\.\d+ ms", r"x\d+(dev|rank)\]",
                    r"\(one .*\)$")
        out.append(re.findall(r"-?\d+(?:,\d{3})*(?:\.\d+)?", line))
    return out


def test_mapreduce_stream_ci_variant_matches_reference(capsys, tmp_path):
    port = _run(capsys, "port", "mapreduce_stream",
                ["--n", "6000", "--scratch", str(tmp_path / "port")])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, str(REPO / "examples" / "mapreduce_stream.py"), "--n", "6000",
         "--scratch", str(tmp_path / "ref")],
        env=env, capture_output=True, text=True, timeout=600, check=True,
    ).stdout
    assert "all exact modes agree" in port
    assert _numbers(port) == _numbers(ref)
    import torch.distributed as dist

    assert not dist.is_initialized()  # the example's world is gone


def test_turnstile_churn_matches_reference(capsys):
    argv = ["--n", "4000", "--planted-k", "100", "--sample-edges", "2048"]  # the CI variant
    port = _run(capsys, "port", "turnstile_churn", argv)
    ref = _run(capsys, "ref", "turnstile_churn", argv)
    # the service-stats dicts differ in their keys (the reference's trace
    # count); every other line, and the K3 count on the CPU, are held.
    body = [ln for ln in port.splitlines() if "service stats" not in ln]
    rbody = [ln for ln in ref.splitlines() if "service stats" not in ln]
    assert _numbers("\n".join(body[:-1])) == _numbers("\n".join(rbody[:-1]))
    assert body[-1].endswith("0 K3 launches")
    assert "OUT OF ENVELOPE" not in port


@pytest.mark.parametrize("example", ["quickstart", "directed_csweep", "engine_matrix",
                                     "mapreduce_stream", "turnstile_churn"])
def test_port_example_raises_without_cuda_by_default(example):
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    mod = _load(REPO / "examples" / "torch_port" / f"{example}.py", f"port_ex_{example}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--n", "500"] if example != "directed_csweep" else [])
