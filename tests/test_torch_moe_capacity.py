"""``moe_capacity`` (the MoE's capacity dispatch) against the reference's on
the CPU: the same numpy-seeded tokens and weights go through
``repro.models.moe.moe_capacity`` and ``repro_torch.models.moe.moe_capacity``.

Cases cover the expert count E, top-k, a shared expert or none, capacity
factors 0.5 (experts overflow and drop assignments), 1.25 and 100 (cap >=
tokens: nothing drops), expert slices given by an offset and ``n_local``
(the blocks of the mesh paths), and tied router weights: tokens repeated
row for row, whose logits are exact sums of dyadic numbers, so that equal
tokens compete for an expert with equal weights and the sort's stability
decides which is dropped.

- the router's expert ids exactly (the premise of what follows);
- the kept assignments exactly: the reference's ``tok_of_slot`` (read by
  wrapping ``jnp.take`` in its module while it is traced, in this process
  only) against
  ``dispatch``'s, slot for slot, and their router weights within 1e-6;
- the output within 1e-5 relative to max(1, max |reference|) (fp32 sums:
  the port adds the weighted rows in fp32 with ``index_add``, the
  reference in XLA's scatter order), the aux loss within 1e-6;
- the gradients of x2d and of every weight against ``jax.vjp`` within
  1e-4 relative (fp32 sums in another order through two matrix products).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402

T, D, FE = 24, 12, 8
# (E, top_k, n_shared, capacity_factor, expert_offset, n_local, tied)
CASES = {
    "e8k2-shared-cf0.5": (8, 2, 1, 0.5, 0, None, False),
    "e8k2-shared-cf1.25": (8, 2, 1, 1.25, 0, None, False),
    "e8k2-cf100": (8, 2, 0, 100.0, 0, None, False),
    "e4k1-cf1.25": (4, 1, 0, 1.25, 0, None, False),
    "e8k3-slice-upper": (8, 3, 1, 1.25, 4, 4, False),
    "e8k2-slice-mid-cf0.5": (8, 2, 0, 0.5, 2, 2, False),
    "e6k2-tied-cf0.5": (6, 2, 1, 0.5, 0, None, True),
    "e6k2-tied-slice": (6, 2, 0, 1.25, 3, 3, True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(e, k, shared, cf):
    base = dict(n_experts=e, top_k=k, d_expert=FE, n_shared=shared, capacity_factor=cf,
                impl="capacity")
    return (dataclasses.replace(ref_get_config("deepseek-v3-671b", reduced=True), d_model=D,
                                moe=RefMoEConfig(**base)),
            dataclasses.replace(get_config("deepseek-v3-671b", reduced=True), d_model=D,
                                moe=MoEConfig(**base)))


def _inputs(e, shared, tied, e_loc, seed):
    """x2d (T, D) and the block's weights (the experts' cut to ``e_loc``),
    numpy fp32.  Tied: 8 distinct token rows of {-1, 0, 1}, each 3 times,
    and a router of multiples of 1/8 (every logit exact)."""
    rng = np.random.default_rng(seed)
    if tied:
        x = np.repeat(rng.integers(-1, 2, (T // 3, D)), 3, axis=0).astype(np.float32)
        router = (rng.integers(-8, 9, (D, e)) / 8.0).astype(np.float32)
    else:
        x = rng.normal(0, 1, (T, D)).astype(np.float32)
        router = rng.normal(0, 0.4, (D, e)).astype(np.float32)
    p = {"router": router,
         "w_gate": rng.normal(0, 0.3, (e_loc, D, FE)).astype(np.float32),
         "w_up": rng.normal(0, 0.3, (e_loc, D, FE)).astype(np.float32),
         "w_down": rng.normal(0, 0.35, (e_loc, FE, D)).astype(np.float32)}
    if shared:
        p |= {"shared_gate": rng.normal(0, 0.3, (D, FE)).astype(np.float32),
              "shared_up": rng.normal(0, 0.3, (D, FE)).astype(np.float32),
              "shared_down": rng.normal(0, 0.35, (FE, D)).astype(np.float32)}
    return x, p


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: max |err| {err}"


class _SpyJnp:
    """The reference module's ``jnp`` with ``take`` recording its indices
    (the dispatch's ``tok_of_slot``) and the last ``where`` result before
    it (``w_of_slot``), as the traced values of the jitted caller."""

    def __init__(self, seen):
        self.seen, self.last_where = seen, None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *a, **kw):
        self.last_where = jnp.where(*a, **kw)
        return self.last_where

    def take(self, a, idx, *args, **kw):
        self.seen["tok_of_slot"], self.seen["w_of_slot"] = idx, self.last_where
        return jnp.take(a, idx, *args, **kw)


def _reference(ref_cfg, ref_p, x, g, kw, monkeypatch):
    """The reference's output, aux, kept slots and its vjp of (g, 0.7), in
    one jitted call traced with the spy in place."""
    def run(pp, xx, gg):
        seen = {}
        monkeypatch.setattr(ref_moe, "jnp", _SpyJnp(seen))
        out, aux = ref_moe.moe_capacity(pp, ref_cfg, xx, **kw)
        monkeypatch.undo()
        _, vjp = jax.vjp(lambda a, b: ref_moe.moe_capacity(a, ref_cfg, b, **kw), pp, xx)
        return out, aux, seen["tok_of_slot"], seen["w_of_slot"], vjp((gg, jnp.float32(0.7)))

    return jax.tree.map(np.asarray, jax.jit(run)(ref_p, jnp.asarray(x), jnp.asarray(g)))


@pytest.mark.parametrize("case", list(CASES))
def test_moe_capacity_matches_reference(case, monkeypatch):
    e, k, shared, cf, offset, n_local, tied = CASES[case]
    e_loc = n_local or e
    ref_cfg, cfg = _cfgs(e, k, shared, cf)
    x, p = _inputs(e, shared, tied, e_loc, seed=sorted(CASES).index(case))
    ref_p = {n: jnp.asarray(v) for n, v in p.items()}
    kw = dict(expert_offset=offset, n_local_experts=n_local)
    g = np.random.default_rng(99).normal(0, 1, (T, D)).astype(np.float32)
    out, aux, ref_tok, ref_w_slot, (want_p, want_x) = _reference(ref_cfg, ref_p, x, g, kw,
                                                                 monkeypatch)
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)

    ref_ids, _, _ = jax.jit(lambda pp, xx: ref_moe._router(pp, ref_cfg, xx))(ref_p, x)
    ids, w, _ = moe._router(tp, cfg, tx)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    tok, w_slot, valid = moe.dispatch(ids, w.detach(), moe.capacity(cfg, T), offset, e_loc)
    np.testing.assert_array_equal(tok.numpy(), ref_tok)
    np.testing.assert_allclose(w_slot.numpy(), ref_w_slot, atol=1e-6, rtol=0)
    cap, local = moe.capacity(cfg, T), ids - offset
    dropped = sum(max(0, int((local == j).sum()) - cap) for j in range(e_loc))
    assert dropped == int(((local >= 0) & (local < e_loc)).sum()) - int(valid.sum())
    if cf != 1.25:
        assert (dropped > 0) == (cf == 0.5), (case, dropped)
    if tied and cf == 0.5:   # an expert's last kept and first dropped weights are equal
        assert any(int((local == j).sum()) > cap and float(ws[cap - 1]) == float(ws[cap])
                   for j in range(e_loc)
                   for ws in [torch.sort(w.detach()[local == j], descending=True).values])

    got, got_aux = moe.moe_capacity(tp, cfg, tx, **kw)
    _close(got, out, 1e-5, "out")
    assert abs(float(got_aux.detach()) - float(aux)) <= 1e-6

    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum() + 0.7 * got_aux,
                                [tx, *tp.values()])
    _close(grads[0], want_x, 1e-4, "dx")
    for name, gk in zip(tp, grads[1:]):
        _close(gk, want_p[name], 1e-4, f"d{name}")


def test_capacity_rounds_half_to_even():
    """cap = round(t k cf / E), Python's round, at least 1."""
    _, cfg = _cfgs(16, 4, 0, 1.25)
    assert [moe.capacity(cfg, t) for t in (4, 8, 24, 1024, 5120)] == [1, 2, 8, 320, 1600]
    _, cfg = _cfgs(256, 8, 1, 1.25)
    assert [moe.capacity(cfg, t) for t in (4, 5120)] == [1, 200]
    _, cfg = _cfgs(8, 2, 0, 1.25)
    assert moe.capacity(cfg, 4) == 1 and moe.capacity(cfg, 12) == 4   # 1.25 -> 1, 3.75 -> 4
    _, cfg = _cfgs(10, 1, 0, 1.25)
    assert [moe.capacity(cfg, t) for t in (2, 4, 12)] == [1, 1, 2]     # 0.25, 0.5 -> 1; 1.5 -> 2
    _, cfg = _cfgs(10, 1, 0, 1.0)
    assert moe.capacity(cfg, 25) == 2                                     # 2.5 -> 2


def test_capacity_refuses_per_client_weights():
    _, cfg = _cfgs(4, 2, 0, 1.25)
    _, p = _inputs(4, 0, False, 4, seed=0)
    cohort = {n: torch.from_numpy(np.stack([v, v])) for n, v in p.items()}
    with pytest.raises(ValueError, match="per-client weights run moe_dense"):
        moe.moe_capacity(cohort, cfg, torch.zeros(2, T, D))
