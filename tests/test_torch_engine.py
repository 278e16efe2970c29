"""Port parity for the slice as a whole: ``fl_cfg()`` runs 3 rounds in the
reference ``HostEngine`` and in the port's engine on the CPU, the port's
randomness replaced by ``JaxReplayDraws``, which replays the reference's
``jax.random`` key chain draw for draw.

Required: identical partition, clusters and ``selected`` every round,
identical ``comm_mb``; params allclose at atol 1e-5 and ``test_acc``
within 1 / len(test).  The tolerances cover fp32 sums taken in different
orders (XLA's matrix products and reductions vs PyTorch's)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import fl_cfg  # noqa: E402

from repro.configs import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs import SSMConfig as RefSSMConfig  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.models.mlp import init_mlp  # noqa: E402
from repro.models.transformer import init_transformer  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax, transformer_params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.engine.draws import TorchDraws  # noqa: E402


def _choice_rows(keys, mask, n):
    """The reference's with-replacement row draw: one ``jax.random.choice``
    per (key, mask row), p = mask / max(mask.sum(), 1e-9)."""

    def one(k, m):
        p = m / jnp.maximum(m.sum(), 1e-9)
        return jax.random.choice(k, m.shape[0], shape=(n,), p=p)

    return jax.vmap(one)(keys, mask)


class JaxReplayDraws:
    """The port's ``draws`` interface, drawing exactly what the reference
    ``Engine`` draws: ``PRNGKey(seed + 17)`` split 3 ways per round into
    (carry, poll, train); the poll splits its key K ways; training folds
    the client id into the train key and splits it per step; the weights
    come from ``init_mlp(PRNGKey(seed))``, or for a transformer spec (a
    ``ModelConfig``) from ``init_transformer(PRNGKey(seed), cfg)``."""

    def __init__(self, seed, device):
        self.seed, self.device = seed, torch.device(device)
        self._key = jax.random.PRNGKey(seed + 17)
        self._round_keys = []
        self._poll = jax.jit(_choice_rows, static_argnums=2)
        self._batch = jax.jit(
            lambda kt, clients, mask, steps, batch: jax.vmap(
                lambda ck, m: _choice_rows(
                    jax.random.split(ck, steps), jnp.broadcast_to(m, (steps,) + m.shape), batch
                )
            )(jax.vmap(lambda i: jax.random.fold_in(kt, i))(clients), mask),
            static_argnums=(3, 4),
        )

    def _keys(self, rnd):
        while len(self._round_keys) <= rnd:
            self._key, k_poll, k_train = jax.random.split(self._key, 3)
            self._round_keys.append((k_poll, k_train))
        return self._round_keys[rnd]

    def _to_torch(self, a):
        return torch.as_tensor(np.array(a), dtype=torch.int64, device=self.device)

    def init_params(self, spec):
        if isinstance(spec, ModelConfig):
            fields = dataclasses.asdict(spec)  # nested configs become dicts: rebuild them
            if spec.ssm is not None:
                fields["ssm"] = RefSSMConfig(**fields["ssm"])
            ref_cfg = RefModelConfig(**fields)
            params = init_transformer(jax.random.PRNGKey(self.seed), ref_cfg)
            flat = transformer_params_from_jax(jax.tree.map(np.asarray, params), spec)
            return flat.to(self.device)
        params = init_mlp(jax.random.PRNGKey(self.seed), spec)
        return params_from_jax(jax.tree.map(np.asarray, params)).to(self.device)

    def poll_indices(self, rnd, probs, n):
        mask = jnp.asarray((probs.cpu().numpy() > 0).astype(np.float32))
        keys = jax.random.split(self._keys(rnd)[0], mask.shape[0])
        return self._to_torch(self._poll(keys, mask, n))

    def batch_indices(self, rnd, clients, probs, steps, batch):
        mask = jnp.asarray((probs.cpu().numpy() > 0).astype(np.float32))
        idx = self._batch(self._keys(rnd)[1], jnp.asarray(clients, jnp.int32), mask, steps, batch)
        return self._to_torch(idx).transpose(0, 1).contiguous()  # (steps, m, batch)


def _run_both(data, **kw):
    train, test = data
    ref_cfg = fl_cfg(**kw)
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=10)
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, 10, device="cpu", draws=JaxReplayDraws(cfg.seed, "cpu"))
    return ref_eng, list(ref_eng.rounds()), eng, list(eng.rounds())


@pytest.mark.parametrize("kw", [{}, {"seed": 1, "m": 5}, {"partition": "dirichlet"}])
def test_rounds_match_reference(data, kw):
    ref_eng, ref_res, eng, res = _run_both(data, **kw)
    assert eng.alpha == ref_eng.alpha
    for a, b in zip(eng.client_idx, ref_eng.client_idx):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(eng.strategy.labels, ref_eng.strategy.labels)
    assert eng.n_params == ref_eng.n_params and eng.max_steps == ref_eng.max_steps
    assert len(res) == len(ref_res) == 3
    n_test = len(data[1].y)
    for r, w in zip(res, ref_res):
        assert r.round == w.round
        assert r.selected == w.selected
        assert r.comm_mb == w.comm_mb
        assert abs(r.test_acc - w.test_acc) <= 1.0 / n_test
        assert abs(r.test_loss - w.test_loss) < 1e-4
        assert abs(r.mean_selected_loss - w.mean_selected_loss) < 1e-4
    want = params_from_jax(jax.tree.map(np.asarray, ref_eng.params)).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, atol=1e-5)
    assert eng.history["selected"] == ref_eng.history["selected"]


def test_config_round_trips_between_packages():
    ref_cfg = fl_cfg()
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    assert cfg.to_dict() == ref_cfg.to_dict()


def test_torch_draws_run_is_deterministic(data):
    train, test = data
    cfg = FLConfig.from_dict(fl_cfg().to_dict())
    a = make_engine(cfg, train, test, 10, device="cpu")
    b = make_engine(cfg, train, test, 10, device="cpu", draws=TorchDraws(cfg.seed, "cpu"))
    ra, rb = list(a.rounds()), list(b.rounds())
    assert [r.selected for r in ra] == [r.selected for r in rb]
    assert torch.equal(a.params, b.params)
    assert all(np.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0 for r in ra)
    assert a.history["round"] == [0, 1, 2]
