"""The port's launch dry-run layer (``repro_torch.launch``) against the
reference's (``repro.launch``).

* ``op_stats`` on the program of ``tests/test_launch_layer.py::_TOY_HLO``
  (a 10-trip loop of [8,128]@[128,128] and an all-reduce over groups of 4
  in 8 ranks), traced on a fake world: its FLOPs and collective bytes
  equal ``hlo_stats.analyze`` of that text exactly, the bf16 wire halving
  included, with the loop run in full or counted by ``loops.uniform``.
* ``Roofline`` with the reference's constants passed in gives the
  reference's terms, bound and roofline fraction (rtol 1e-12).
* Traced dot FLOPs per device against the reference's compiled HLO (8
  forced host devices) on a (2, 4) mesh for densest-mapreduce x flickr_sm
  and two-tower x serve_p99, within the ratio pinned in
  ``DOT_FLOPS_RATIO``.
* The four cells of ``test_cells_compile_on_small_mesh`` and qwen2-72b x
  long_500k's skip on a fake (2, 4) world, and the CLI on one cell of the
  production mesh.

Fake worlds and forced host devices each need a process of their own, so
those parts run in children.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro.launch import hlo_stats
from repro.launch import roofline as ref_roofline

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_launch_layer import _TOY_HLO  # noqa: E402

from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

# ours / the reference's compiled dot FLOPs per device, (lo, hi): densest
# has no product on either side; two-tower serve_p99 runs the same towers
# on each device's shard of the batch and of the tower widths.
DOT_FLOPS_RATIO = {
    "densest-mapreduce/flickr_sm": None,  # both 0
    "two-tower-retrieval/serve_p99": (0.999, 1.001),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    return env


def _child(code: str, timeout: int, extra_env=None):
    env = _env()
    env.update(extra_env or {})
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=REPO)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT=")]
    assert line, (res.stdout[-2000:], res.stderr[-4000:])
    return json.loads(line[-1][len("RESULT="):])


_TOY = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import loops
from repro_torch.launch.op_stats import OpStats

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
groups = [dist.new_group([0, 1, 2, 3]), dist.new_group([4, 5, 6, 7])]
out = {}
for name, dt, counted in [("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
                          ("f32_counted", torch.float32, True)]:
    fake = FakeTensorMode()
    with fake:
        h = torch.empty(8, 128, dtype=dt)
        w = torch.empty(128, 128, dtype=dt)
    st = OpStats()
    with fake, loops.counting(), st:
        for _ in (loops.uniform(range(10), 10) if counted else range(10)):
            h = h @ w
            dist.all_reduce(h, group=groups[0])
    out[name] = st.result()
print("RESULT=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def toy():
    return _child(_TOY, timeout=300)


@pytest.mark.parametrize("case", ["f32", "f32_counted"])
def test_op_stats_toy_equals_hlo_stats(toy, case):
    want = hlo_stats.analyze(_TOY_HLO, n_devices=8)
    got = toy[case]
    assert got["flops"] == want["flops"] == 2 * 8 * 128 * 128 * 10
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["by_collective"] == {"all-reduce": want["by_collective"]["all-reduce"]}
    assert got["collective_count"] == 10 and got["unknown_trip_loops"] == 0


def test_op_stats_toy_bf16_wire_halved(toy):
    want = hlo_stats.analyze(_TOY_HLO.replace("to_apply=%sum", "to_apply=%add.clone_promoted"),
                             n_devices=8)
    assert toy["bf16"]["collective_bytes"] == want["collective_bytes"]
    assert toy["bf16"]["flops"] == want["flops"]


REF_CHIP = roofline.ChipSpec(
    name="TPU v5e (the reference's constants)", peak_flops_bf16=ref_roofline.PEAK_FLOPS_BF16,
    hbm_bw=ref_roofline.HBM_BW, hbm_bytes=ref_roofline.HBM_PER_CHIP,
    nvlink_bw=ref_roofline.ICI_BW, net_bw=ref_roofline.ICI_BW,
    source="repro.launch.roofline (test only)")

CASES = [
    (197e12, 819e9 / 2, 50e9 * 2, 197e12 * 256 / 2, 256, 0.0),
    (1.3e15, 4.1e12, 2.2e9, 7.9e16, 256, 0.0),
    (2.0e12, 9.0e11, 6.0e11, 1.0e14, 512, 2.0e11),
    (0.0, 1e9, 0.0, 0.0, 256, 0.0),
]


@pytest.mark.parametrize("flops,hbm,coll,model,n,intra", CASES)
def test_roofline_with_reference_constants(flops, hbm, coll, model, n, intra):
    want = ref_roofline.Roofline(arch="x", shape="y", mesh="16x16", n_devices=n,
                                 flops_per_dev=flops, hbm_bytes_per_dev=hbm,
                                 coll_bytes_per_dev=coll, model_flops_total=model)
    got = roofline.Roofline(arch="x", shape="y", mesh="16x16", n_devices=n,
                            flops_per_dev=flops, hbm_bytes_per_dev=hbm, coll_bytes_per_dev=coll,
                            model_flops_total=model, coll_bytes_intra_node=intra, chip=REF_CHIP)
    for key in ("compute_s", "memory_s", "collective_s", "step_time_s", "model_flops_ratio",
                "roofline_fraction"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=1e-12, abs=0), key
    assert got.bound == want.bound
    assert roofline.fmt_row(got) == ref_roofline.fmt_row(want)


def test_h100_constants_and_the_intra_node_split():
    chip = roofline.H100_SXM
    assert (chip.peak_flops_bf16, chip.hbm_bw, chip.hbm_bytes) == (989e12, 3.35e12, 80e9)
    r = roofline.Roofline(arch="x", shape="y", mesh="16x16", n_devices=256, flops_per_dev=0.0,
                          hbm_bytes_per_dev=0.0, coll_bytes_per_dev=9e9, model_flops_total=0.0,
                          coll_bytes_intra_node=4.5e9)
    assert r.collective_s == pytest.approx(4.5e9 / chip.nvlink_bw + 4.5e9 / chip.net_bw)


_E2E = r"""
import json
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.cells import SkipCell, build_cell, trace_cell

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch, shape in [("llama3.2-3b", "train_4k"), ("graphsage-reddit", "ogb_products"),
                    ("two-tower-retrieval", "serve_p99"), ("densest-mapreduce", "flickr_sm")]:
    tr = trace_cell(build_cell(arch, shape, mesh=mesh))
    out[f"{arch}/{shape}"] = {"flops": tr.stats["flops"], "coll": tr.stats["collective_bytes"],
                              "hbm": tr.stats["hbm_bytes"], "args": sum(tr.arg_bytes.values()),
                              "peak": tr.peak_bytes}
try:
    build_cell("qwen2-72b", "long_500k", mesh=mesh)
    out["skip"] = "MISSED"
except SkipCell:
    out["skip"] = "ok"
print("RESULT=" + json.dumps(out))
"""


def test_cells_trace_on_small_fake_mesh():
    out = _child(_E2E, timeout=600)
    assert out["skip"] == "ok"
    assert out["llama3.2-3b/train_4k"]["flops"] > 1e12
    assert out["densest-mapreduce/flickr_sm"]["coll"] > 0
    for key, rec in out.items():
        if key != "skip":
            assert rec["hbm"] > 0 and 0 < rec["args"] <= rec["peak"], key


def test_dryrun_cli_one_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "densest-mapreduce",
         "--shape", "flickr_sm", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("[     ok] densest-mapreduce x flickr_sm (16x16)")
    rec = json.loads((tmp_path / "densest-mapreduce__flickr_sm__16x16.json").read_text())
    assert rec["chip"]["name"] == roofline.H100_SXM.name
    assert rec["info"]["expected_passes"] == 35 and rec["info"]["n_devices"] == 256
    assert rec["op_stats"]["collective_count"] == 64  # one all-reduce a pass, 64 passes
    recs = report.load(str(tmp_path))
    assert "| densest-mapreduce | flickr_sm | 16x16 | ok |" in report.dryrun_table(recs)
    assert "| densest-mapreduce | flickr_sm |" in report.roofline_table(recs)
    assert report.pick_hillclimb(recs)["worst_fraction"][0][0] == "densest-mapreduce"


_REF_DOTS = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
from repro.launch import hlo_stats
from repro.launch.cells import build_cell, lower_cell
from repro.launch.mesh import make_mesh

def dot_flops(hlo):
    comps = hlo_stats.parse_computations(hlo)
    entry = [ln for ln in hlo.splitlines() if ln.startswith("ENTRY")][0]
    entry = hlo_stats._COMP_RE.match(entry.strip()).group(1)
    mult, order = {entry: 1.0}, [entry]
    while order:
        comp = order.pop(0)
        for ins in comps.get(comp, []):
            subs, k = [], mult[comp]
            if ins.opcode == "while":
                m = hlo_stats._COND_BODY_RE.search(ins.line)
                if m:
                    k *= hlo_stats._trip_count(comps.get(m.group(1), []), comps) or 1
                    subs = [m.group(2)]
            elif ins.opcode in ("call", "fusion", "conditional"):
                m = hlo_stats._TO_APPLY_RE.search(ins.line) or hlo_stats._CALLS_RE.search(ins.line)
                subs = [m.group(1)] if m else []
            for s in subs:
                if s not in mult:
                    order.append(s)
                mult[s] = mult.get(s, 0.0) + k
    total = 0.0
    for comp, instrs in comps.items():
        dims = {i.name: i.result_dims for i in instrs}
        total += mult.get(comp, 0.0) * sum(hlo_stats._dot_flops(i, dims)
                                          for i in instrs if i.opcode == "dot")
    return total

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch, shape in [("densest-mapreduce", "flickr_sm"), ("two-tower-retrieval", "serve_p99")]:
    hlo = lower_cell(build_cell(arch, shape, mesh=mesh)).compile().as_text()
    out[f"{arch}/{shape}"] = dot_flops(hlo)
print("RESULT=" + json.dumps(out))
"""

_PORT_DOTS = r"""
import json
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.cells import build_cell, trace_cell
mesh = make_mesh((2, 4), ("data", "model"))
out = {f"{a}/{s}": trace_cell(build_cell(a, s, mesh=mesh)).stats["flops"]
       for a, s in [("densest-mapreduce", "flickr_sm"), ("two-tower-retrieval", "serve_p99")]}
print("RESULT=" + json.dumps(out))
"""


@pytest.mark.slow
def test_dot_flops_against_compiled_hlo():
    want = _child(_REF_DOTS, timeout=900)
    got = _child(_PORT_DOTS, timeout=300)
    for key, limits in DOT_FLOPS_RATIO.items():
        if limits is None:
            assert got[key] == want[key] == 0.0, key
        else:
            lo, hi = limits
            assert want[key] > 0 and lo <= got[key] / want[key] <= hi, (key, got[key], want[key])
