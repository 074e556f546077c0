"""Port parity: ``benchmarks/torch_port/paper_benches.py`` against the
reference's ``benchmarks/paper_benches.py``, and the port's runner.

The reference's functions hard-code the paper's sizes (``fig61`` draws
200,000 nodes), too slow here; the port's take the sizes as arguments.
Each case runs the port's function at a small size, and the reference's
own function on the same graphs: its generator module is swapped for one
that draws the same graph at the small size (``_Shrunk``).  Every field
that times nothing must be equal.  ``fig67`` runs the reference in this
process on its one CPU device (not in its 8-device child) and the port on
a one-rank gloo mesh it starts and destroys; ``kernels`` is held against
the degrees ``numpy.bincount`` gives, since the reference times its XLA
path on another layout.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import paper_benches as ref_pb  # noqa: E402
from benchmarks.torch_port import paper_benches as port_pb  # noqa: E402
from benchmarks.torch_port import run as port_run  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402

TIMING = {"wall_s", "s_per_pass", "edges_per_s", "one_time_shuffle_s", "us_per_pass"}


class _Shrunk:
    """``repro.graph.generators`` with each ``n=`` in ``sizes`` replaced."""

    def __init__(self, sizes):
        self.sizes = sizes

    def __getattr__(self, name):
        fn = getattr(ref_gen, name)

        def shrunk(*args, **kw):
            if "n" in kw:
                kw["n"] = self.sizes.get(kw["n"], kw["n"])
            return fn(*args, **kw)

        return shrunk


def _same_rows(got, want, drop=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        keys = (set(w) & set(g)) - TIMING - set(drop)
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}


CASES = {
    # name: (port kwargs, the reference's sizes -> the small ones)
    "table2": (dict(n=300), {1500: 300, 1200: 240}),
    "fig61": (dict(n=3000), {200_000: 3000}),
    "fig62_63": (dict(n=3000), {100_000: 3000}),
    "table3": (dict(n=1500), {30_000: 1500}),
    "fig64_66": (dict(n=1500), {30_000: 1500}),
    "table4": (dict(n=3000), {97_600: 3000}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paper_bench_matches_reference(name, monkeypatch):
    kw, sizes = CASES[name]
    monkeypatch.setattr(ref_pb, "gen", _Shrunk(sizes))
    _same_rows(port_pb.ALL[name](device="cpu", **kw), ref_pb.ALL[name]())


def test_lemma5_matches_reference():
    _same_rows(port_pb.lemma5(k_values=(2, 3, 4), device="cpu"),
               ref_pb.lemma5(k_values=(2, 3, 4)))


def test_fig67_matches_reference_one_rank(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("_FIG67_CHILD", "1")  # the reference in this process
    monkeypatch.setattr(ref_pb, "gen", _Shrunk({50_000: 3000, 200_000: 5000, 500_000: 8000}))
    got = port_pb.fig67(sizes=((3000, 8.0), (5000, 10.0), (8000, 12.0)), device="cpu")
    assert not dist.is_initialized()  # the world fig67 started is gone
    assert [r["ranks"] for r in got] == [1, 1, 1]
    assert [r["nodes"] for r in got] == [3000, 5000, 8000]
    _same_rows(got, ref_pb.fig67(), drop=("nodes",))  # the reference's: its loop's sizes


def test_kernels_row_counts_the_degrees():
    (row,) = port_pb.kernels(n=2000, e=12_000, repeats=2, device="cpu")
    assert row["equal_to_plain_and_index_add"] is True
    assert row["edge_slots"] == 2 * 12_000 and row["kernel_launches"] == 0
    assert row["bound_us"] > 0 and row["timer"] == "host clock"
    # the function itself: degrees over both endpoints of the drawn edges
    import torch

    from repro_torch.graph.partition import bucket_edges_by_tile
    from repro_torch.kernels.peel_degree.ops import tiled_degrees

    rng = np.random.default_rng(0)
    src = rng.integers(0, 2000, 12_000).astype(np.int32)
    dst = rng.integers(0, 2000, 12_000).astype(np.int32)
    tiling = bucket_edges_by_tile(torch.as_tensor(src), torch.as_tensor(dst), 2000,
                                  tile_size=1024)
    deg = tiled_degrees(tiling, torch.ones(12_000), n_nodes=2000)
    want = np.bincount(src, minlength=2000) + np.bincount(dst, minlength=2000)
    assert np.array_equal(deg.numpy(), want.astype(np.float32))


def test_run_writes_each_table_with_its_device(tmp_path, monkeypatch):
    """``benchmarks.torch_port.run`` on the CPU: one JSON per name under
    experiments/bench/torch/, with the rows and ``"device": "cpu"``."""
    import json

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(port_pb.ALL, "lemma5",
                        lambda device: port_pb.lemma5(k_values=(2, 3), device=device))
    assert port_run.main(["lemma5", "--device", "cpu"]) == 0
    rec = json.loads((tmp_path / "experiments" / "bench" / "torch" / "lemma5.json").read_text())
    assert rec["device"] == "cpu" and rec["name"] == "lemma5" and len(rec["rows"]) == 2
    with pytest.raises(SystemExit):
        port_run.main(["no_such_table", "--device", "cpu"])
