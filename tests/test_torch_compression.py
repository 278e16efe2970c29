"""Quantized cohort uploads (``compress_bits``) against the reference.

``compressed_fedavg`` must give the reference's parameters to 1e-6 on
identical cohorts, weights and rounding uniforms, with one scale a
(client, reference leaf), on the MLP's leaves and on a transformer's
(whose leaves are stacked over the layers in the reference and split by
layer in the port's flat vector).  A compiled ``compress_bits=8`` run
must equal the reference's under ``JaxReplayDraws`` (which replays its
quantization uniforms) within the host-parity tolerance, and stay within
the reference's bound of 5e-3 of the exact host run while billing fewer
MB."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import LM_VOCAB, fl_cfg, lm_fl_cfg  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.federated.compression import compressed_fedavg as ref_compressed_fedavg  # noqa: E402
from repro.models.mlp import init_mlp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    leaf_segments,
    params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.federated.compression import compressed_fedavg  # noqa: E402
from repro_torch.models.mlp import MLPLayout  # noqa: E402
from repro_torch.models.transformer import TransformerLayout  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _micro_lm():
    ov = lm_fl_cfg().task_kwargs["overrides"]
    return dataclasses.replace(get_config("stablelm-3b"), **ov, n_layers=2, dtype="float32")


@pytest.mark.parametrize("model", ["mlp", "transformer"])
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_fedavg_matches_reference(model, bits):
    m = 4
    if model == "mlp":
        sizes = (64, 16, 10)
        trees = [init_mlp(jax.random.PRNGKey(i), sizes) for i in range(m + 1)]
        flatten, layout = params_from_jax, MLPLayout(sizes)
    else:
        cfg = _micro_lm()
        draws = JaxReplayDraws(0, "cpu")
        draws.init_params(cfg)  # keeps the reference's tree, for its leaf shapes
        rng = np.random.default_rng(0)
        trees = [jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                              draws._template) for _ in range(m + 1)]
        flatten, layout = draws._flatten, TransformerLayout(cfg)
    g, clients = trees[0], trees[1:]
    stacked_ref = jax.tree.map(lambda *xs: jnp.stack(xs), *clients)
    w = np.random.default_rng(1).random(m).astype(np.float32)
    w /= w.sum()
    key = jax.random.PRNGKey(7)
    want, want_err = jax.jit(ref_compressed_fedavg, static_argnames="bits")(
        stacked_ref, g, jnp.asarray(w), key, bits=bits)
    keys = jax.random.split(key, m)
    uniforms = torch.stack([flatten(jax.tree.map(
        lambda a, k=k: np.asarray(jax.random.uniform(k, a.shape)), g)) for k in keys])
    cohort = torch.stack([flatten(jax.tree.map(np.asarray, c)) for c in clients])
    leaves = leaf_segments(layout)
    assert len(leaves) == len(jax.tree.leaves(g))
    cover = sorted(piece for leaf in leaves for piece in leaf)
    assert cover[0][0] == 0 and cover[-1][1] == cohort.shape[1]
    assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
    got, err = compressed_fedavg(cohort, flatten(jax.tree.map(np.asarray, g)), torch.from_numpy(w),
                                 lambda a, b: uniforms[:, a:b].clone(), leaves, bits=bits)
    np.testing.assert_allclose(got.numpy(), flatten(jax.tree.map(np.asarray, want)).numpy(),
                               atol=1e-6)
    assert float(err) == pytest.approx(float(want_err), rel=1e-4)


@pytest.mark.parametrize("task", ["classification", "lm"])
def test_compressed_engine_matches_reference_and_exact(task, data, lm_data):
    train, test = lm_data if task == "lm" else data
    make_cfg, n_classes, rounds = (lm_fl_cfg, LM_VOCAB, 2) if task == "lm" else (fl_cfg, 10, 3)
    ref_cfg = make_cfg(backend="compiled", compress_bits=8)
    ref = ref_make_engine(ref_cfg, train, test, n_classes=n_classes)
    ref_res = list(ref.rounds(rounds))
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    quant = make_engine(cfg, train, test, n_classes, device="cpu",
                        draws=JaxReplayDraws(cfg.seed, "cpu"))
    res = list(quant.rounds(rounds))
    exact = make_engine(FLConfig.from_dict({**cfg.to_dict(), "backend": "host",
                                            "compress_bits": 0}),
                        train, test, n_classes, device="cpu",
                        draws=JaxReplayDraws(cfg.seed, "cpu"))
    ex_res = list(exact.rounds(rounds))
    assert [r.selected for r in res] == [r.selected for r in ref_res]
    assert res[-1].comm_mb == pytest.approx(ref_res[-1].comm_mb)
    flat = jax.tree.map(np.asarray, ref.params)
    if task == "lm":
        want = transformer_params_from_jax(flat, quant.task.model_cfg).numpy()
    else:
        want = params_from_jax(flat).numpy()
    np.testing.assert_allclose(quant.params.numpy(), want, atol=1e-5)
    assert quant.last_quant_error == pytest.approx(ref.last_quant_error, rel=1e-3)
    # against the exact run: fewer MB billed, parameters within the int8 budget
    assert res[0].selected == ex_res[0].selected
    assert res[-1].comm_mb < ex_res[-1].comm_mb
    np.testing.assert_allclose(quant.params.numpy(), exact.params.numpy(), atol=5e-3)


def test_fused_compressed_matches_eager_compressed(data):
    kw = dict(backend="compiled", compress_bits=8, rounds=3, eval_every=1)
    train, test = data
    runs = []
    for fuse in (0, 3):
        cfg = FLConfig.from_dict(fl_cfg(fuse_rounds=fuse, **kw).to_dict())
        engine = make_engine(cfg, train, test, 10, device="cpu")
        runs.append((list(engine.rounds()), engine))
    (ra, ea), (rb, eb) = runs
    assert [r.selected for r in ra] == [r.selected for r in rb]
    assert float((ea.params - eb.params).abs().max()) < 1e-6
    assert ea.last_quant_error == pytest.approx(eb.last_quant_error)
