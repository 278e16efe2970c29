"""Port parity for xlstm-125m, the LM task's default model: the same numpy
inputs go through the JAX package and the port on the CPU.

- the config, full and reduced, equals the reference's;
- ``chunked_linear_scan``, ``mlstm_seq`` and ``slstm_seq`` at B = 2, S =
  16, d = 32, H = 2, with one chunk (16, 32) and with two (8), and their
  gradients against ``jax.vjp``;
- the parameter layout, the init's distributions and the ``convert``
  round trip;
- a 4-layer ``MMMS`` micro model (three mLSTM layers and one sLSTM layer),
  forward, head and gradient;
- 2 rounds of the LM task (one local step each) on that micro model over
  128-token sequences (two mLSTM chunks and two scan chunks) against the reference
  ``HostEngine`` under ``JaxReplayDraws``, each round from the
  reference's parameters at its start (``_check_rounds`` says why); and
  one round each of ``FLConfig(task="lm")`` with no ``task_kwargs`` and of
  the ``fedlecc_lm`` preset.

Tolerances: 1e-5 relative to max(1, max |reference|) for the blocks and
the model, whose fp32 sums and scans run in another order than XLA's (a
Hillis–Steele scan against ``associative_scan``'s tree; sLSTM's
stabiliser as F_t + cummax(i - F) against the (max, +) scan) and 1e-4
for their gradients; a round's metrics within 1e-4 and its parameters
within 1e-5 relative to max(1, max |reference|), as in the other LM
slices."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import LM_VOCAB, lm_fl_cfg  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.synthetic import make_token_stream  # noqa: E402
from repro.engine import FLConfig as RefFLConfig  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.engine.presets import get_preset as ref_get_preset  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.transformer import forward as ref_forward  # noqa: E402
from repro.models.transformer import init_transformer as ref_init_transformer  # noqa: E402
from repro.models.transformer import output_head as ref_output_head  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    transformer_params_from_jax,
    transformer_params_to_numpy,
)
from repro_torch.engine import FLConfig, get_preset, make_engine  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    TransformerLayout,
    forward,
    init_transformer,
    layer_flags,
    output_head,
)

B, S, D, H = 2, 16, 32, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small engine runs from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _cfgs(chunk=8, **over):
    """The reduced xlstm at d = 32, H = 2 and the given chunk, both packages."""
    ov = {"d_model": D, "vocab": LM_VOCAB, "loss_chunk": 16, **over}
    ref = dataclasses.replace(ref_get_config("xlstm-125m", reduced=True), **ov)
    port = dataclasses.replace(get_config("xlstm-125m", reduced=True), **ov)
    ref = dataclasses.replace(ref, ssm=dataclasses.replace(ref.ssm, chunk=chunk))
    port = dataclasses.replace(port, ssm=dataclasses.replace(port.ssm, chunk=chunk))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port) and port.ssm.n_heads == H
    return ref, port


def test_config_matches_reference():
    for reduced in (False, True):
        ref = ref_get_config("xlstm-125m", reduced=reduced)
        port = get_config("xlstm-125m", reduced=reduced)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    full = get_config("xlstm-125m")
    assert (full.n_layers, full.d_model, full.block_type, full.layer_pattern) == (
        12, 768, "xlstm", "MMMS")


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("decay", [0.9, 1e-3])
def test_chunked_linear_scan_matches_reference(chunk, decay):
    """decay 1e-3: the running product of a underflows to 0 in fp32 within
    a chunk; the scan never divides by it."""
    rng = np.random.default_rng(chunk)
    a = (decay * rng.uniform(0.5, 1.0, (B, S, H, 4))).astype(np.float32)
    b = rng.normal(0, 1, (B, S, H, 4)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, H, 4)).astype(np.float32)
    dh = rng.normal(0, 1, (B, S, H, 4)).astype(np.float32)
    (want, want_fin), vjp = jax.vjp(jax.jit(lambda *t: ref_ssm.chunked_linear_scan(*t, chunk)),
                                    a, b, h0)
    want_grads = vjp((jnp.asarray(dh), jnp.zeros_like(want_fin)))
    leaves = [_t(t).requires_grad_(True) for t in (a, b, h0)]
    got, got_fin = ssm.chunked_linear_scan(*leaves, chunk)
    assert torch.isfinite(got).all()
    _close(got.detach(), want, 1e-5)
    _close(got_fin.detach(), want_fin, 1e-5)
    for g, w in zip(torch.autograd.grad(got, leaves, _t(dh)), want_grads):
        _close(g, w, 1e-4)


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    dy = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("core", ["mlstm_seq", "slstm_seq"])
def test_xlstm_cores_and_gradients_match_reference(core, chunk):
    ref_cfg, cfg = _cfgs(chunk)
    ref_p = ref_ssm.init_xlstm(jax.random.PRNGKey(chunk), ref_cfg)
    # a trained block's core norm and gate biases are not the init's
    ref_p = {**ref_p, "core_norm": 0.1 * jax.random.normal(jax.random.PRNGKey(7), (D,)),
             "b_if": ref_p["b_if"] + 0.5 * jax.random.normal(jax.random.PRNGKey(8), (2 * H,))}
    x, dy = _block_inputs(chunk)
    ref_fn = getattr(ref_ssm, core)
    want, vjp = jax.vjp(jax.jit(lambda p, xx: ref_fn(p, ref_cfg, xx)[0]), ref_p, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(dy))
    names = list(ssm.xlstm_shapes(cfg))
    p = {k: _t(ref_p[k]).requires_grad_(True) for k in names}
    xt = _t(x).requires_grad_(True)
    got = getattr(ssm, core)(p, cfg, xt)[0]
    assert torch.isfinite(got).all()
    _close(got.detach(), want, 1e-5)
    # sLSTM reads neither wq nor wk: no gradient, zeros in the reference
    grads = torch.autograd.grad(got, [xt] + [p[k] for k in names], _t(dy), allow_unused=True)
    _close(grads[0], want_dx, 1e-4)
    for k, g in zip(names, grads[1:]):
        _close(torch.zeros_like(p[k]) if g is None else g, want_dp[k], 1e-4)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_normaliser_overflow_keeps_the_gradient_finite(chunk):
    """Head 0's input-gate bias at -120 puts every running max m below
    -log(FLT_MAX): exp(-m) is inf, head 0's output num / inf = 0, and the
    reference's gradient is NaN (0 x inf in exp's backward).  The port gives
    the reference's output there, and the gradient that the reference gives
    with the bias at -80, where exp(-m) stays finite and head 0's output
    and gradient are below 1e-30."""
    ref_cfg, cfg = _cfgs(chunk)
    base = ref_ssm.init_xlstm(jax.random.PRNGKey(chunk), ref_cfg)
    x, dy = _block_inputs(chunk)

    def ref_run(bias):
        p = {**base, "b_if": base["b_if"].at[0].set(bias)}
        out, vjp = jax.vjp(jax.jit(lambda pp, xx: ref_ssm.mlstm_seq(pp, ref_cfg, xx)[0]),
                           p, jnp.asarray(x))
        return p, out, vjp(jnp.asarray(dy))

    over_p, over_out, (over_dp, over_dx) = ref_run(-120.0)
    _, near_out, (near_dp, near_dx) = ref_run(-80.0)
    assert np.isnan(over_dx).any() and np.isnan(over_dp["b_if"]).any()
    assert np.isfinite(near_dx).all() and all(np.isfinite(v).all() for v in near_dp.values())
    names = list(ssm.xlstm_shapes(cfg))
    p = {k: _t(over_p[k]).requires_grad_(True) for k in names}
    xt = _t(x).requires_grad_(True)
    got = ssm.mlstm_seq(p, cfg, xt)[0]
    _close(got.detach(), over_out, 1e-5)
    _close(got.detach(), near_out, 1e-5)
    grads = torch.autograd.grad(got, [xt] + [p[k] for k in names], _t(dy))
    assert all(torch.isfinite(g).all() for g in grads)
    _close(grads[0], near_dx, 1e-4)
    for k, g in zip(names, grads[1:]):
        _close(g, near_dp[k], 1e-4)


def test_xlstm_cores_take_per_client_weights():
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    blocks = [ssm.init_xlstm(gen, cfg) for _ in range(3)]
    cohort = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    x = torch.randn(3, B, S, D, generator=gen)
    for core in (ssm.mlstm_seq, ssm.slstm_seq):
        got = core(cohort, cfg, x)[0]
        for i in range(3):
            torch.testing.assert_close(got[i], core(blocks[i], cfg, x[i])[0], atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the model: layout, init, conversion, forward
# ---------------------------------------------------------------------------


def test_layout_follows_the_reference_tree_and_init():
    ref_cfg, cfg = _cfgs(n_layers=4)
    shapes = jax.eval_shape(lambda k: ref_init_transformer(k, ref_cfg), jax.random.PRNGKey(0))
    layout = TransformerLayout(cfg)
    assert layout.entries[:9] == [
        (("layers", 0, "xlstm", name), tuple(shapes["layers"]["xlstm"][name].shape[1:]))
        for name in ("w_up", "wq", "wk", "wv", "w_if", "b_if", "w_down", "core_norm")
    ] + [(("layers", 0, "norm1"), (D,))]
    assert layout.n_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert layer_flags(cfg)["is_mlstm"].tolist() == [1.0, 1.0, 1.0, 0.0]
    assert layer_flags(get_config("xlstm-125m", reduced=True))["is_mlstm"].tolist() == [1.0, 1.0]

    big = dataclasses.replace(cfg, d_model=256, vocab=512)
    tree = TransformerLayout(big).views(init_transformer(torch.Generator().manual_seed(0), big))
    block = tree["layers"][3]["xlstm"]
    assert torch.equal(block["b_if"], torch.tensor([0.0] * H + [3.0] * H))
    assert torch.equal(block["core_norm"], torch.zeros(256))
    assert torch.equal(tree["layers"][3]["norm1"], torch.zeros(256))
    for name in ("w_up", "wq", "wk", "wv", "w_if", "w_down"):
        assert abs(block[name].std().item() * np.sqrt(256) - 1.0) < 0.1, name


@pytest.fixture(scope="module")
def micro():
    """The 4-layer MMMS micro model with two mLSTM chunks at S = 16."""
    ref_cfg, cfg = _cfgs(8, n_layers=4)
    ref_params = ref_init_transformer(jax.random.PRNGKey(0), ref_cfg)
    ref_params["layers"]["xlstm"]["core_norm"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), ref_params["layers"]["xlstm"]["core_norm"].shape)
    return ref_cfg, cfg, ref_params, transformer_params_from_jax(
        jax.tree.map(np.asarray, ref_params), cfg)


def test_conversion_round_trips_exactly(micro):
    _, cfg, ref_params, flat = micro
    back = transformer_params_to_numpy(flat, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))
    assert torch.equal(transformer_params_from_jax(back, cfg), flat)


def test_micro_forward_head_and_gradient_match_reference(micro):
    """The reference computes both cores a layer and keeps one with
    ``jnp.where``; the port only the flagged one: same output, same
    gradient."""
    ref_cfg, cfg, ref_params, flat = micro
    toks = np.random.default_rng(0).integers(0, LM_VOCAB, (3, S)).astype(np.int32)
    dh = np.random.default_rng(1).normal(0, 1, (3, S, D)).astype(np.float32)
    want, vjp = jax.vjp(jax.jit(lambda p: ref_forward(p, ref_cfg,
                                                      {"tokens": jnp.asarray(toks)})[0]),
                        ref_params)
    (want_grad,) = vjp(jnp.asarray(dh))
    leaf = flat.clone().requires_grad_(True)
    got = forward(leaf, cfg, _t(toks))
    _close(got.detach(), want, 1e-5)
    (grad,) = torch.autograd.grad(got, leaf, _t(dh))
    want_flat = transformer_params_from_jax(jax.tree.map(np.asarray, want_grad), cfg)
    _close(grad, want_flat, 1e-4)
    head = output_head(TransformerLayout(cfg).views(flat), cfg)
    np.testing.assert_array_equal(head.numpy(), np.asarray(ref_output_head(ref_params, ref_cfg)))


# ---------------------------------------------------------------------------
# the LM task on xlstm
# ---------------------------------------------------------------------------

# The 4-layer MMMS micro model as task_kwargs; over 128-token sequences the
# reduced config's chunk of 64 gives two mLSTM chunks and two scan chunks
XLSTM_MICRO = {"model": "xlstm-125m", "hist_bins": 16,
               "overrides": {"n_layers": 4, "d_model": D, "vocab": LM_VOCAB, "loss_chunk": 16}}


@pytest.fixture(scope="module")
def long_data():
    return make_token_stream(48, 128, LM_VOCAB, seed=0), make_token_stream(16, 128, LM_VOCAB,
                                                                           seed=1)


def _check_rounds(ref_cfg, data, n_classes, rounds):
    """``rounds`` rounds in both packages, each started from the
    reference's parameters at the round's start: the xLSTM LM's training
    is chaotic in the reference itself (``scripts/xlstm_sensitivity.py``:
    a relative perturbation of 1e-6 of the initial weights moves the
    micro model's test loss by 1e-2 after one round at S = 16 and by 4e-2
    after two at S = 128, the stablelm micro model's by 1e-6; the RMS norm
    of a 0.02-scale embedding scales its gradient by ~50, and mLSTM's
    normaliser max(|n|, exp(-m)) has a kink), so fp32 noise that one round
    leaves would grow without bound over the next; each round is held to
    the reference on the same inputs instead."""
    train, test = data
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=n_classes)
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, n_classes, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu"))
    mc = eng.task.model_cfg
    assert mc.block_type == "xlstm"
    assert eng.n_params == ref_eng.n_params and eng.max_steps == ref_eng.max_steps
    np.testing.assert_array_equal(eng.strategy.labels, ref_eng.strategy.labels)
    ref_it, it = ref_eng.rounds(rounds), eng.rounds(rounds)
    for _ in range(rounds):
        eng.params = transformer_params_from_jax(jax.tree.map(np.asarray, ref_eng.params), mc)
        w, r = next(ref_it), next(it)
        assert (r.round, r.selected, r.comm_mb) == (w.round, w.selected, w.comm_mb)
        assert abs(r.test_loss - w.test_loss) <= 1e-4
        assert abs(r.mean_selected_loss - w.mean_selected_loss) <= 1e-4
        assert abs(r.metrics["ppl"] - w.metrics["ppl"]) <= 1e-4 * max(1.0, w.metrics["ppl"])
        want = transformer_params_from_jax(jax.tree.map(np.asarray, ref_eng.params), mc)
        _close(eng.params, want, 1e-5)
    assert next(it, None) is None and next(ref_it, None) is None


def test_xlstm_micro_rounds_match_reference(long_data):
    """One local step a round.  With two, the packages' test losses differ
    by 8e-5 after the first round, close to the 1e-4 tolerance: the chaos
    that ``_check_rounds`` describes acts within a round as well.  The
    one-round tests below take two steps a round on wider models, whose
    losses differ by 2e-6 at most."""
    ref_cfg = lm_fl_cfg(task_kwargs=XLSTM_MICRO, max_steps_cap=1)
    assert ref_cfg.task_kwargs["overrides"]["n_layers"] == 4
    _check_rounds(ref_cfg, long_data, LM_VOCAB, 2)


SMALL = dict(n_clients=8, m=3, rounds=1, batch_size=4, eval_samples=4, eval_every=1,
             target_hd=0.8, max_steps_cap=2, seed=0)


def test_default_lm_config_builds_and_runs_the_reference_round(lm_data):
    """``FLConfig(task="lm")`` with no ``task_kwargs``: the reduced
    xlstm-125m (2 mLSTM layers, d_model 256, vocab 512)."""
    assert FLConfig(task="lm").task_kwargs == {}
    _check_rounds(RefFLConfig(task="lm", strategy_kwargs={"J": 2}, **SMALL), lm_data, 512, 1)


def test_fedlecc_lm_preset_builds_and_runs_the_reference_round(lm_data):
    cfg = get_preset("fedlecc_lm").make_config(**SMALL)
    want = ref_get_preset("fedlecc_lm").make_config(**SMALL)
    assert cfg.to_dict() == want.to_dict()
    _check_rounds(want, lm_data, 128, 1)
