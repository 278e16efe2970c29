"""Port parity: OPTICS against ``repro.core.clustering``.

Given the same distance matrix, the port's ordering, reachability, core
distances and labels are identical to the reference's.  End to end (from
histograms), the two packages build the Hellinger matrix with fp32 inner
products summed in different orders, so distances may differ in the last
bits: labels must still be identical, the reachability profile in visit
order must agree as 1 - r² at atol 1e-6, and on the planted histograms
and the engine's partitions the ordering itself must be identical."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import planted_histograms  # noqa: E402

import repro.core.clustering as ref  # noqa: E402
from repro.data.partition import label_histograms, shard_partition  # noqa: E402
import repro_torch.core.clustering as port  # noqa: E402
from repro_torch.core.hellinger import hellinger_blocked  # noqa: E402

PLANTED = [(0, 60, 10, 4), (1, 60, 10, 4), (2, 100, 10, 6), (3, 40, 16, 3), (4, 200, 10, 8)]
# (clients, shards per client) partitions of the 800-sample task; (12, 3) is
# the shard count fl_cfg() calibrates to and (12, 1) its neighbour
ENGINE_PARTS = [(12, 3), (12, 1)]
MORE_PARTS = [(100, 1), (100, 2), (30, 4)]


def _planted(seed, k, c, g):
    return planted_histograms(np.random.default_rng(seed), K=k, C=c, G=g)[0]


def _partition(data, k, s):
    y = data[0].y
    return label_histograms(y, shard_partition(y, k, s, seed=0), 10)


def _profile_bc(res):
    r = np.asarray(res.reachability, np.float64)[np.asarray(res.ordering)]
    return np.where(np.isfinite(r), 1.0 - r * r, -1.0)


def _end_to_end(hists, exact_ordering):
    want_labels, want = ref.cluster_label_histograms(hists)
    got_labels, got = port.cluster_label_histograms(hists, device="cpu")
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(_profile_bc(got), _profile_bc(want), atol=1e-6)
    if exact_ordering:
        np.testing.assert_array_equal(got.ordering, np.asarray(want.ordering))
    return got_labels


def _same_matrix(hists):
    d = hellinger_blocked(hists, device="cpu")
    got, want = port.optics(d), ref.optics(d)
    np.testing.assert_array_equal(got.ordering, np.asarray(want.ordering))
    np.testing.assert_array_equal(got.reachability, np.asarray(want.reachability))
    np.testing.assert_array_equal(got.core_distances, np.asarray(want.core_distances))
    np.testing.assert_array_equal(port.extract_clusters(got), ref.extract_clusters(want))


@pytest.mark.parametrize("case", PLANTED)
def test_optics_planted_histograms_identical(case):
    hists = _planted(*case)
    _same_matrix(hists)
    _end_to_end(hists, exact_ordering=True)


@pytest.mark.parametrize("k,s", ENGINE_PARTS)
def test_optics_engine_partitions_identical(data, k, s):
    hists = _partition(data, k, s)
    _same_matrix(hists)
    _end_to_end(hists, exact_ordering=True)


@pytest.mark.parametrize("k,s", MORE_PARTS)
def test_optics_more_partitions_labels_identical(data, k, s):
    hists = _partition(data, k, s)
    _same_matrix(hists)
    _end_to_end(hists, exact_ordering=False)


def test_paper_scale_partition_gives_ten_clusters_of_ten():
    y = np.repeat(np.arange(10), 200)  # 2,000 labels, 10 classes
    hists = label_histograms(y, shard_partition(y, 100, 1, seed=0), 10)
    labels = _end_to_end(hists, exact_ordering=True)  # one-hot: HD is exactly 0 or 1
    assert labels.max() + 1 == 10
    assert np.all(np.bincount(labels) == 10)


@pytest.mark.parametrize("eps", [0.05, 0.3, 0.9, float("inf")])
def test_extract_clusters_fixed_eps_identical(eps):
    d = hellinger_blocked(_planted(5, 60, 10, 4), device="cpu")
    got = port.extract_clusters(port.optics(d), eps=eps)
    want = ref.extract_clusters(ref.optics(d), eps=eps)
    np.testing.assert_array_equal(got, want)


def test_optics_ties_visit_in_index_order():
    d = np.zeros((5, 5), np.float32)  # every distance ties
    res = port.optics(d, min_samples=2)
    np.testing.assert_array_equal(res.ordering, np.arange(5))
    np.testing.assert_array_equal(res.ordering, np.asarray(ref.optics(d, min_samples=2).ordering))
