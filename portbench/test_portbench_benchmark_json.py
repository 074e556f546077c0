"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and the files it names."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
TEXT = re.compile(r"[^\t\n\r]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.fullmatch(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
        assert (spec.ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _entries():
    return [(key, e) for key in ("configs", "workloads", "end_to_end", "per_layer")
            for e in BENCH[key]]


@pytest.mark.parametrize("key,entry", _entries(),
                         ids=[f"{k}.{e['name']}" for k, e in _entries()])
def test_names_and_text_fields(key, entry):
    assert spec.NAME_RE.fullmatch(entry["name"])
    if key in ("end_to_end", "per_layer"):
        assert spec.UNIT_RE.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for field in ("why", "layer", "source"):
        if field in entry:
            assert TEXT.fullmatch(entry[field])


def test_no_two_entries_share_a_name():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert len(c["reduced"]) <= 16 and all(spec.NAME_RE.fullmatch(k) for k in c["reduced"])
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] == c["name"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert spec.NAME_RE.fullmatch(w["traffic"]) and TEXT.fullmatch(w["why"])
        traffic = json.loads((spec.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["name"] == w["traffic"]
        assert traffic["query"] in ("solve", "solve_batch")


def test_metrics_and_their_readers():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e}
        assert set(m.get("workloads", cells)) <= cells
    for m in e2e + BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        got = spec.load_cell(cell)
        assert "setup_s" in {m.name for m in got.metrics_of("end_to_end")}
        assert len(got.metrics_of("end_to_end")) >= 2 and got.metrics_of("per_layer")


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
