"""Port parity: the generators this slice adds to
``repro_torch.graph.generators`` (``barabasi_albert``, ``lemma5_instance``
with ``_regular_circulant``, ``planted_partition``,
``weighted_preferential``) against ``repro.graph.generators``, bitwise:
``src``, ``dst``, ``weight``, ``mask``, ``n_nodes`` and the labels, over a
few seeds and sizes; and the shape arguments ``chip_smoke.py`` draws its
graphs from."""

import numpy as np
import pytest

from repro.graph import generators as ref
from repro_torch.configs import densest_mapreduce
from repro_torch.graph import generators as gen


def _same_graph(got, want):
    assert got.n_nodes == want.n_nodes
    assert got.directed == want.directed
    for f in ("src", "dst", "weight", "mask"):
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("n,m_attach,seed", [(60, 2, 0), (300, 4, 1), (500, 5, 4)])
def test_barabasi_albert_matches_reference(n, m_attach, seed):
    _same_graph(gen.barabasi_albert(n, m_attach, seed, device="cpu"),
                ref.barabasi_albert(n, m_attach, seed))


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_lemma5_instance_matches_reference(k):
    _same_graph(gen.lemma5_instance(k, device="cpu"), ref.lemma5_instance(k))


@pytest.mark.parametrize("n,d", [(8, 1), (9, 2), (10, 3), (16, 4), (12, 5)])
def test_regular_circulant_matches_reference(n, d):
    got = gen._regular_circulant(n, d, 7)
    want = ref._regular_circulant(n, d, 7)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,k,p_in,p_out,seed", [
    (200, 4, 0.3, 0.01, 0),
    (301, 3, [0.5, 0.3, 0.1], 0.02, 2),
    (1000, 5, 0.05, 0.001, 7),
])
def test_planted_partition_matches_reference(n, k, p_in, p_out, seed):
    got, labels = gen.planted_partition(n, k, p_in, p_out, seed, device="cpu")
    want, want_labels = ref.planted_partition(n, k, p_in, p_out, seed)
    _same_graph(got, want)
    assert labels.tobytes() == want_labels.tobytes()


@pytest.mark.parametrize("n", [2, 3, 40, 150])
def test_weighted_preferential_matches_reference(n):
    _same_graph(gen.weighted_preferential(n, device="cpu"), ref.weighted_preferential(n))


def test_new_generators_raise_without_cuda_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("the card is present: the default device is valid")
    for call in (lambda: gen.barabasi_albert(20, 2), lambda: gen.lemma5_instance(2),
                 lambda: gen.planted_partition(20, 2, 0.5, 0.1),
                 lambda: gen.weighted_preferential(5)):
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.parametrize("shape", ["flickr_sm", "livejournal_md"])
def test_shapes_give_chip_smoke_graph_arguments(shape):
    """The config's shapes and SPEC equal the reference's, and the Chung-Lu
    arguments derived from a shape are the ones chip_smoke.py used to copy
    by hand (the same floats, so the same graphs)."""
    from repro.configs import densest_mapreduce as ref_cfg

    assert {k: (v.kind, dict(v.params)) for k, v in densest_mapreduce.SHAPES.items()} == {
        k: (v.kind, dict(v.params)) for k, v in ref_cfg.SHAPES.items()}
    assert densest_mapreduce.CONFIG.__dict__ == ref_cfg.CONFIG.__dict__
    assert densest_mapreduce.REDUCED.__dict__ == ref_cfg.REDUCED.__dict__
    by_hand = {
        "flickr_sm": dict(n=976_000, exponent=2.2, avg_deg=2 * 7.6e6 / 976_000, seed=0),
        "livejournal_md": dict(n=4_840_000, exponent=2.2, avg_deg=2 * 68.9e6 / 4_840_000,
                               seed=0),
    }[shape]
    assert densest_mapreduce.chung_lu_args(shape) == by_hand


def test_registry_has_densest_mapreduce():
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import NOT_PORTED

    assert "densest-mapreduce" not in NOT_PORTED
    spec = get_arch("densest-mapreduce")
    assert spec.family == "densest" and set(spec.shapes) == {
        "flickr_sm", "livejournal_md", "twitter_lg", "im_xl"}
