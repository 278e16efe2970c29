"""Port parity: the Hellinger module and the strip kernel's plain version
against ``repro.core.hellinger``, the reference oracle
``hellinger_matrix_ref`` and the Pallas strip kernel in interpret mode.

Distances are compared as 1 - HD² (the Bhattacharyya coefficient) at
atol 1e-6: both sides sum fp32 products in different orders, and
sqrt(1 - bc) would magnify a 1e-7 difference in bc near bc = 1 into
3e-4 in HD.  Diagonals must be exactly 0."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core.hellinger as ref  # noqa: E402
from repro.kernels.hellinger.ops import hellinger_strip_pallas  # noqa: E402
from repro.kernels.hellinger.ref import hellinger_matrix_ref  # noqa: E402
import repro_torch.core.hellinger as port  # noqa: E402
from repro_torch.kernels.hellinger import hellinger_strip, hellinger_strip_ref  # noqa: E402

SHAPES = [(16, 4), (100, 10), (129, 33), (256, 128)]  # tests/test_kernels.py sweep
ATOL_BC = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bc(d):
    d = np.asarray(d, np.float64)
    return 1.0 - d * d


def _hists(k, c, seed=None):
    rng = np.random.default_rng(k + c if seed is None else seed)
    h = rng.dirichlet(np.ones(c) * 0.5, size=k)
    h[0] = h[1]  # one exact duplicate pair: bc = 1 up to rounding
    return h


@pytest.mark.parametrize("k,c", SHAPES)
def test_hellinger_matrix_matches_reference(k, c):
    h = _hists(k, c)
    got = port.hellinger_matrix(h).numpy()
    assert got.dtype == np.float32 and got.shape == (k, k)
    np.testing.assert_allclose(_bc(got), _bc(ref.hellinger_matrix(jnp.asarray(h))), atol=ATOL_BC)
    np.testing.assert_allclose(_bc(got), _bc(hellinger_matrix_ref(jnp.asarray(h))), atol=ATOL_BC)
    assert np.all(np.diag(got) == 0.0)


@pytest.mark.parametrize("k,c", SHAPES)
def test_strip_plain_version_matches_pallas_interpret(k, c):
    h = _hists(k, c)
    r = ref._sqrt_rows(h)
    b = max(1, k // 3)
    want = np.asarray(hellinger_strip_pallas(jnp.asarray(r[:b]), jnp.asarray(r), interpret=True))
    got = hellinger_strip_ref(torch.from_numpy(r[:b].copy()), torch.from_numpy(r)).numpy()
    assert got.shape == (b, k) and got.dtype == np.float32
    np.testing.assert_allclose(_bc(got), _bc(want), atol=ATOL_BC)


@pytest.mark.parametrize("k,c", SHAPES)
@pytest.mark.parametrize("block", [7, 64, 4096])
def test_hellinger_blocked_matches_reference(k, c, block):
    h = _hists(k, c)
    got = port.hellinger_blocked(h, block=block, device="cpu")
    want = ref.hellinger_blocked(h, block=block, use_kernel=False)
    assert got.dtype == np.float32 and got.shape == (k, k)
    np.testing.assert_allclose(_bc(got), _bc(want), atol=ATOL_BC)
    assert np.all(np.diag(got) == 0.0)
    # the blocked build is the dense matrix, strip by strip
    np.testing.assert_allclose(_bc(got), _bc(port.hellinger_matrix(h).numpy()), atol=ATOL_BC)


@pytest.mark.parametrize("k,c", SHAPES)
def test_hellinger_rows_matches_reference(k, c):
    h = _hists(k, c)
    q = _hists(5, c, seed=99)
    got = port.hellinger_rows(q, h, device="cpu")
    np.testing.assert_allclose(_bc(got), _bc(ref.hellinger_rows(q, h)), atol=ATOL_BC)


@pytest.mark.parametrize("k,c", SHAPES)
def test_average_hd_and_distance_match_reference(k, c):
    h = _hists(k, c)
    assert abs(float(port.average_hd(h)) - float(ref.average_hd(jnp.asarray(h)))) < 1e-6
    got = port.hellinger_distance(h[2], h[3]).item()
    want = float(ref.hellinger_distance(jnp.asarray(h[2]), jnp.asarray(h[3])))
    assert abs((1 - got**2) - (1 - want**2)) < ATOL_BC


def test_one_hot_histograms_give_exact_zero_and_one():
    h = np.eye(10)[np.arange(30) % 10]
    d = port.hellinger_blocked(h, device="cpu")
    same = (np.arange(30)[:, None] % 10) == (np.arange(30)[None, :] % 10)
    assert np.all(d[same] == 0.0) and np.all(d[~same] == 1.0)


def test_dense_budget_warning():
    old = port.set_dense_budget_bytes(16 * 16 * 4 - 1)
    try:
        with pytest.warns(ResourceWarning):
            port.hellinger_blocked(_hists(16, 4), device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            port.hellinger_blocked(_hists(15, 4), device="cpu")
    finally:
        port.set_dense_budget_bytes(old)
    with pytest.raises(ValueError):
        port.set_dense_budget_bytes(0)


def test_strip_wrapper_checks_and_cpu_path():
    r = torch.rand(8, 4)
    before = hellinger_strip.launches
    assert torch.equal(hellinger_strip(r, r), hellinger_strip_ref(r, r))
    assert hellinger_strip.launches == before  # CPU tensors never launch
    with pytest.raises(TypeError):
        hellinger_strip(r.double(), r.double())
    with pytest.raises(ValueError):
        hellinger_strip(r, torch.rand(8, 5))
    with pytest.raises(ValueError):
        hellinger_strip(r.t(), r.t())
    with pytest.raises(ValueError):
        port.hellinger_blocked(_hists(8, 4), block=0, device="cpu")


@pytest.mark.parametrize("k,c", SHAPES + [(1000, 10)])
def test_hellinger_blocked_is_the_single_strip_build_bit_for_bit(k, c):
    # every entry is its strip element's bits, however the rows are cut
    h = _hists(k, c)
    np.testing.assert_array_equal(port.hellinger_blocked(h, block=7, device="cpu"),
                                  port.hellinger_blocked(h, block=k, device="cpu"))
