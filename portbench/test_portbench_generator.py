"""The on-card Chung-Lu generator's arithmetic, run on the CPU at a tiny n."""

import json

import pytest
import torch

from portbench import spec
from portbench.generators import chung_lu

TINY = {"n_nodes": 4000, "draws": 20000, "exponent": 2.2}


def test_edges_are_canonical_sorted_and_distinct():
    src, dst = chung_lu.edges(TINY, seed=3, device="cpu")
    assert src.dtype == dst.dtype == torch.int32
    assert bool((src < dst).all())  # no self-loop, each edge once as (lo, hi)
    key = src.long() * TINY["n_nodes"] + dst.long()
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicate
    assert int(dst.max()) < TINY["n_nodes"] and int(src.min()) >= 0


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**33 + 1])
def test_same_seed_same_graph_and_seeds_differ(seed):
    a = chung_lu.edges(TINY, seed=seed, device="cpu")
    b = chung_lu.edges(TINY, seed=seed, device="cpu")
    c = chung_lu.edges(TINY, seed=seed + 1, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (a[0].shape == c[0].shape and torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]))


def test_edge_count_follows_the_draws():
    # At exponent 2.2 duplicates and self-loops of the hubs take a few
    # percent of the draws.
    counts = [int(chung_lu.edges(TINY, seed=s, device="cpu")[0].shape[0]) for s in range(4)]
    for m in counts:
        assert 0.80 * TINY["draws"] < m < TINY["draws"]
    assert max(counts) - min(counts) < 0.03 * TINY["draws"]  # the seed moves little


def test_hubs_get_the_lowest_ids():
    n = TINY["n_nodes"]
    src, dst = chung_lu.edges(TINY, seed=11, device="cpu")
    deg = torch.bincount(torch.cat([src, dst]).long(), minlength=n)
    assert int(deg.argmax()) < 10
    assert deg[: n // 10].sum() > 3 * deg[-n // 10:].sum()


def test_benchmark_configs_name_the_generator():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (spec.HERE / "generators" / f"{cfg['generator']}.py").is_file()
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_expected_matches_the_draws(seed):
    # chung_lu.expected against a graph drawn at a small n: distinct edges
    # within 0.5%, node 0's degree within four Poisson deviations.
    cfg = {"n_nodes": 20000, "draws": 150000, "exponent": 2.6}
    want = chung_lu.expected(cfg["n_nodes"], cfg["exponent"], cfg["draws"])
    src, dst = chung_lu.edges(cfg, seed=seed, device="cpu")
    deg0 = int((src == 0).sum()) + int((dst == 0).sum())
    assert abs(src.shape[0] - want["edges"]) < 0.005 * want["edges"]
    assert abs(deg0 - want["max_degree"]) < 4 * want["max_degree"] ** 0.5
    deg = torch.bincount(torch.cat([src, dst]).long(), minlength=cfg["n_nodes"])
    assert int(deg.argmax()) == 0


def test_fit_reaches_its_targets():
    exponent, draws = chung_lu.fit(4000, 20000, 150, tol=1e-5)
    got = chung_lu.expected(4000, exponent, draws)
    assert got["max_degree"] == pytest.approx(150, rel=2e-3)
    assert got["edges"] == pytest.approx(20000, abs=1.0)
    assert draws >= 20000


def test_configs_are_fitted_to_their_published_statistics():
    # Each configuration's exponent and draws give, in expectation, the
    # published maximum degree and edge count it names.
    for c in spec.load_benchmark()["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        got = chung_lu.expected(cfg["n_nodes"], cfg["exponent"], cfg["draws"])
        assert got["max_degree"] == pytest.approx(cfg["max_degree"], rel=1e-3)
        assert got["edges"] == pytest.approx(cfg["edges"], abs=10.0)
