"""Port parity for the optimizer substrate (``repro_torch.optim``): the same
numpy-seeded parameters and gradients go through the reference's
optimizers and the port's over 5 updates, on one tree with fp32 and bf16
leaves.

Tolerances: fp32 leaves within 1e-6 relative (XLA may contract a product
and a sum into one rounding where PyTorch rounds twice); bf16 leaves
within one unit in the last place of bf16 (the same fp32 update, rounded
to bf16 on either side of a tie).  The schedules within 1e-6; the
reference's quadratic-descent cases as in ``tests/test_optim.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.optim.optimizers import apply_updates as ref_apply_updates  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim.optimizers import apply_updates  # noqa: E402

SHAPES = {"a": ((7, 5), "float32"), "b": ((11,), "float32"), "c": ((4, 6), "bfloat16"),
          "d": ((3,), "bfloat16")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {k: rng.standard_normal(shape).astype(np.float32) * scale
            for k, (shape, _) in SHAPES.items()}


def _ref(tree):
    return {k: jnp.asarray(v, SHAPES[k][1]) for k, v in tree.items()}


def _port(tree):
    return {k: torch.from_numpy(v).to(getattr(torch, SHAPES[k][1])) for k, v in tree.items()}


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _assert_tree_close(got, want):
    for k, (_, dt) in SHAPES.items():
        g = got[k].to(torch.float32).numpy()
        w = np.asarray(jnp.asarray(want[k], jnp.float32))
        assert got[k].dtype == getattr(torch, dt), k
        if dt == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert np.all(np.abs(g - w) <= _ulp_bf16(w)), (k, np.abs(g - w).max())


OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd-momentum": lambda o: o.sgd(0.05, momentum=0.9),
    "sgd-nesterov": lambda o: o.sgd(0.05, momentum=0.9, nesterov=True),
    "adamw": lambda o: o.adamw(3e-3),
    "adamw-decay-schedule": lambda o: o.adamw(o.warmup_cosine(1e-2, 2, 5), weight_decay=0.01),
    "launcher": lambda o: o.chain(o.clip_by_global_norm(1.0),
                                  o.adamw(o.warmup_cosine(3e-4, 10, 5), weight_decay=0.01)),
    "clip-sgd": lambda o: o.chain(o.clip_by_global_norm(0.5), o.sgd(0.1)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference_over_five_updates(name):
    rng = np.random.default_rng(0)
    params0 = _tree(rng)
    grads = [_tree(rng, scale=0.5 + i) for i in range(5)]
    ref_opt, opt = OPTIMIZERS[name](ref_optim), OPTIMIZERS[name](optim)
    ref_p, p = _ref(params0), _port(params0)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for g in grads:
        ref_u, ref_s = ref_opt.update(_ref(g), ref_s, ref_p)
        u, s = opt.update(_port(g), s, p)
        _assert_tree_close(u, ref_u)
        ref_p, p = ref_apply_updates(ref_p, ref_u), apply_updates(p, u)
        _assert_tree_close(p, ref_p)
    ref_leaves = jax.tree.leaves(ref_s)
    leaves = torch.utils._pytree.tree_leaves(s)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=1e-5,
                                   atol=1e-6)


def test_adamw_moments_are_fp32_for_bf16_leaves():
    p = _port(_tree(np.random.default_rng(1)))
    s = optim.adamw(1e-3).init(p)
    assert s["count"].dtype == torch.int32 and int(s["count"]) == 0
    assert all(s[k][n].dtype == torch.float32 for k in ("m", "v") for n in SHAPES)


@pytest.mark.parametrize("count", [0, 5, 10, 50, 100])
def test_schedules_match_reference(count):
    ref_c, c = jnp.asarray(count, jnp.int32), torch.tensor(count, dtype=torch.int32)
    for args in ((1.0, 10, 100), (3e-4, 10, 50, 1e-5), (0.5, 0, 100)):
        want = float(ref_optim.warmup_cosine(*args)(ref_c))
        got = optim.warmup_cosine(*args)(c)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    assert float(optim.constant(0.3)(c)) == float(ref_optim.constant(0.3)(ref_c))


def test_clip_and_chain():
    clip = optim.clip_by_global_norm(1.0)
    g = {"a": torch.tensor([3.0, 4.0])}                 # norm 5
    out, state = clip.update(g, clip.init(g), None)
    assert state == () and abs(float(torch.linalg.norm(out["a"])) - 1.0) < 1e-6
    g2 = {"a": torch.tensor([0.3, 0.4])}                # norm 0.5: untouched
    out2, _ = clip.update(g2, clip.init(g2), None)
    torch.testing.assert_close(out2["a"], g2["a"], atol=1e-7, rtol=0)
    # a bf16 leaf keeps its type; the norm is summed in fp32 over every leaf
    g3 = {"a": torch.tensor([3.0]), "b": [torch.tensor([4.0], dtype=torch.bfloat16)]}
    out3, _ = clip.update(g3, (), None)
    assert out3["b"][0].dtype == torch.bfloat16
    assert abs(float(out3["a"][0]) - 0.6) < 1e-6
    chained = optim.chain(clip, optim.sgd(0.1))
    state = chained.init(g)
    assert isinstance(state, tuple) and state[0] == ()
    upd, state = chained.update(g, state, g)
    torch.testing.assert_close(upd["a"], torch.tensor([-0.06, -0.08]))
    assert int(state[1]["count"]) == 1


def _quadratic_descends(opt, steps=200):
    target = torch.tensor([3.0, -2.0, 1.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(steps):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        upd, state = opt.update({"w": g}, state, params)
        params = apply_updates(params, upd)
    return float(torch.sum((params["w"] - target) ** 2))


@pytest.mark.parametrize(
    "make",
    [lambda: optim.sgd(0.1), lambda: optim.sgd(0.05, momentum=0.9),
     lambda: optim.sgd(0.05, momentum=0.9, nesterov=True), lambda: optim.adamw(0.05),
     lambda: optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(0.1))],
    ids=["sgd", "sgd-mom", "sgd-nesterov", "adamw", "clip+sgd"],
)
def test_optimizers_minimize_quadratic(make):
    assert _quadratic_descends(make()) < 1e-2
