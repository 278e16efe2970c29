"""Port parity: synthetic data and partitioning are bit-identical to the
JAX package's (same seed, same arrays, same calibrated shard count /
alpha)."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.data.partition as ref_part  # noqa: E402
from repro.data.synthetic import make_classification as ref_make  # noqa: E402
from repro_torch.data import partition as port_part  # noqa: E402
from repro_torch.data.synthetic import make_classification as port_make  # noqa: E402


@pytest.mark.parametrize("n,f,c,seed", [(300, 64, 10, 0), (200, 16, 4, 7), (50, 784, 10, 3)])
def test_make_classification_bit_identical(n, f, c, seed):
    a, b = ref_make(n, n_features=f, n_classes=c, seed=seed), port_make(n, n_features=f, n_classes=c, seed=seed)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype


def _same_parts(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        assert pa.dtype == pb.dtype


@pytest.mark.parametrize("k,s,seed", [(12, 1, 0), (12, 3, 1), (30, 2, 5), (100, 1, 0)])
def test_shard_partition_bit_identical(data, k, s, seed):
    y = data[0].y
    _same_parts(ref_part.shard_partition(y, k, s, seed=seed),
                port_part.shard_partition(y, k, s, seed=seed))


@pytest.mark.parametrize("k,alpha,seed", [(12, 0.5, 0), (30, 0.05, 2), (100, 0.01, 1)])
def test_dirichlet_partition_bit_identical(data, k, alpha, seed):
    y = data[0].y
    _same_parts(ref_part.dirichlet_partition(y, k, alpha, seed=seed),
                port_part.dirichlet_partition(y, k, alpha, seed=seed))


@pytest.mark.parametrize("k,target,seed", [(12, 0.8, 0), (30, 0.9, 1), (100, 0.9, 0), (12, 0.5, 3)])
def test_calibrate_shards_identical(data, k, target, seed):
    y = data[0].y
    assert port_part.calibrate_shards(y, k, target, 10, seed=seed) == \
        ref_part.calibrate_shards(y, k, target, 10, seed=seed)


@pytest.mark.parametrize("k,target", [(12, 0.8), (30, 0.6)])
def test_calibrate_alpha_identical(data, k, target):
    y = data[0].y
    assert port_part.calibrate_alpha(y, k, target, 10, seed=0) == \
        ref_part.calibrate_alpha(y, k, target, 10, seed=0)


def test_label_histograms_and_pack_clients_bit_identical(data):
    train = data[0]
    parts = ref_part.dirichlet_partition(train.y, 12, 0.3, seed=4)
    np.testing.assert_array_equal(ref_part.label_histograms(train.y, parts, 10),
                                  port_part.label_histograms(train.y, parts, 10))
    for a, b in zip(ref_part.pack_clients(train.x, train.y, parts),
                    port_part.pack_clients(train.x, train.y, parts)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
