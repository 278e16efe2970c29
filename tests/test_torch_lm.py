"""Port parity for the federated LM slices: the same numpy inputs go through
the JAX package and the port on the CPU, module by module (token stream,
norms, activation, RoPE, attention and its gradient, the stablelm and
hymba forwards, the LM task) and for each slice as a whole (``lm_fl_cfg()``
on stablelm and on a hymba micro config, in both ``HostEngine``s under the
reference's draws).

Tolerances: 1e-6 for elementwise fp32 ops (one or two roundings apart);
1e-5 for attention, the transformer and the losses, whose fp32 sums run
in another order in XLA than in PyTorch; 2e-2 for bf16 attention, one
rounding of a value of size ~1 to bf16's 8 mantissa bits; 1e-4 for the
round metrics after two rounds of training, as in the MLP slice.
"""

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
from repro.data.synthetic import make_token_stream as ref_make_token_stream  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.engine.tasks import build_task as ref_build_task  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention_pallas  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models.transformer import forward as ref_forward  # noqa: E402
from repro.models.transformer import init_transformer as ref_init_transformer  # noqa: E402
from repro.models.transformer import output_head as ref_output_head  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    transformer_params_from_jax,
    transformer_params_to_numpy,
)
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.engine.tasks import build_task  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention_backward,
    flash_attention_forward,
)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    TransformerLayout,
    forward,
    init_transformer,
    layer_flags,
    output_head,
)

MICRO = lm_fl_cfg().task_kwargs["overrides"]


def _micro_cfgs():
    """The stablelm micro config of ``lm_fl_cfg`` in both packages."""
    ov = {"dtype": "float32", **MICRO}
    ref = dataclasses.replace(ref_get_config("stablelm-3b", reduced=True), **ov)
    port = dataclasses.replace(get_config("stablelm-3b", reduced=True), **ov)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# configs, data, building blocks
# ---------------------------------------------------------------------------


def test_stablelm_config_matches_reference():
    for reduced in (False, True):
        ref = ref_get_config("stablelm-3b", reduced=reduced)
        port = get_config("stablelm-3b", reduced=reduced)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_hymba_config_matches_reference():
    for reduced in (False, True):
        ref = ref_get_config("hymba-1.5b", reduced=reduced)
        port = get_config("hymba-1.5b", reduced=reduced)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.source == "arXiv:2411.13676"


@pytest.mark.parametrize("name", ["xlstm-125m", "dbrx-132b", "deepseek-v3-671b"])
def test_unported_configs_name_their_slice(name):
    with pytest.raises(ValueError, match="repro_torch does not implement .* arrives in"):
        get_config(name)


@pytest.mark.parametrize("args", [(48, 16, 32, 0), (64, 64, 50304, 1), (5, 9, 7, 3)])
def test_token_stream_is_bit_identical(args):
    n, s, v, seed = args
    want, got = ref_make_token_stream(n, s, v, seed=seed), make_token_stream(n, s, v, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_norms_and_gelu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (3, 5, 24)).astype(np.float32)
    scale = rng.normal(0, 1, 24).astype(np.float32)
    bias = rng.normal(0, 1, 24).astype(np.float32)
    pairs = [
        (common.layer_norm(_t(x), _t(scale), _t(bias)),
         ref_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))),
        (common.rms_norm(_t(x), _t(scale)), ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        (common.activation("gelu", _t(x)), ref_common.activation("gelu", jnp.asarray(x))),
        (common.activation("swiglu", _t(x), _t(x[::-1].copy())),
         ref_common.activation("swiglu", jnp.asarray(x), jnp.asarray(x[::-1].copy()))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("fraction", [0.25, 1.0])
def test_rope_matches_reference(fraction):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 12, 3, 80)).astype(np.float32)
    dim = int(80 * fraction)
    sin, cos = common.rope_table(12, dim, 10000.0)
    rsin, rcos = ref_common.rope_table(12, dim, 10000.0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-6)
    got = common.apply_rope(_t(x), sin, cos, fraction)
    want = ref_common.apply_rope(jnp.asarray(x), rsin, rcos, fraction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if fraction < 1:  # the dims past the rotated pairs pass through untouched
        assert torch.equal(got[..., dim:], _t(x)[..., dim:])


# ---------------------------------------------------------------------------
# attention: the plain version (CPU path of the kernel) and its gradient
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [  # the sweep of tests/test_kernels.py
    (1, 128, 2, 1, 64, 0, "float32"),
    (2, 256, 4, 2, 32, 0, "float32"),
    (1, 128, 4, 4, 128, 64, "float32"),
    (2, 128, 2, 1, 64, 0, "bfloat16"),
]


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, s, n, d)).astype(np.float32) for n in (h, kv, kv))


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype", KERNEL_SHAPES)
def test_attention_matches_reference_and_pallas(b, s, h, kv, d, window, dtype):
    q, k, v = _qkv(b, s, h, kv, d, s + h + d)
    ig = 0.0 if window else 1.0
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    got = attn.flash_attention(tq, tk, tv, window, ig).to(torch.float32).numpy()
    atol = 1e-5 if dtype == "float32" else 2e-2
    want = ref_attn.flash_attention(jq, jk, jv, window, ig, 64, 64)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol)
    pallas = flash_attention_pallas(jq, jk, jv, window=window, is_global=ig, bq=64, bk=64,
                                    interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), atol=atol)
    naive = attn.naive_attention(tq, tk, tv, window, ig).to(torch.float32).numpy()
    np.testing.assert_allclose(naive, got, atol=atol)


@pytest.mark.parametrize("b,s,h,kv,d,window,dtype",
                         [c for c in KERNEL_SHAPES if c[-1] == "float32"]
                         + [(2, 40, 4, 2, 16, 8, "float32")])
def test_attention_gradient_matches_jax_vjp(b, s, h, kv, d, window, dtype):
    q, k, v = _qkv(b, s, h, kv, d, 7 * s + d)
    g = np.random.default_rng(s).normal(0, 1, (b, s, h, d)).astype(np.float32)
    ig = 0.0 if window else 1.0
    chunk = 8 if s % 64 else 64
    _, vjp = jax.vjp(lambda a, b_, c: ref_attn.flash_attention(a, b_, c, window, ig, chunk, chunk),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = attn.flash_attention(*leaves, window, ig)
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)


def test_attention_plain_version_returns_log_sum_exp():
    q, k, v = _qkv(2, 33, 4, 1, 16, 3)
    o, lse = attention_ref(_t(q), _t(k), _t(v), 5, 0.0)
    scores = np.einsum("bqhd,bkd->bhqk", q, k[:, :, 0]) / 4.0
    pos = np.arange(33)
    ok = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 5)
    want = np.log(np.where(ok, np.exp(scores), 0.0).sum(-1))
    assert lse.shape == (2, 4, 33) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)
    assert o.shape == (2, 33, 4, 16)


def test_attention_kernel_wrappers_take_cuda_tensors_only():
    q, k, v = (_t(a) for a in _qkv(1, 8, 2, 2, 16, 0))
    before = (flash_attention_forward.launches, flash_attention_backward.launches)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    attn.flash_attention(*leaves).sum().backward()  # CPU: the plain version and its autograd
    assert (flash_attention_forward.launches, flash_attention_backward.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_backward(q, k, v, q, q[:, :, :, 0], q)
    with pytest.raises(ValueError, match="KV must divide H"):
        attn.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1].expand(1, 8, 3, 16))


# ---------------------------------------------------------------------------
# stablelm: init, conversion, forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro():
    ref_cfg, cfg = _micro_cfgs()
    ref_params = ref_init_transformer(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_params, transformer_params_from_jax(
        jax.tree.map(np.asarray, ref_params), cfg)


def test_transformer_conversion_round_trips_exactly(micro):
    _, cfg, ref_params, flat = micro
    assert flat.shape == (TransformerLayout(cfg).n_params,) and flat.dtype == torch.float32
    back = transformer_params_to_numpy(flat, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))
    assert torch.equal(transformer_params_from_jax(back, cfg), flat)


VARIANTS = [  # the stablelm micro config, and the other options the dense block ports
    {},
    {"qk_norm": True, "n_kv_heads": 1, "norm": "rmsnorm", "mlp_activation": "swiglu"},
    {"sliding_window": 4, "layer_pattern": "LG", "rope_theta_global": 1e6,
     "tie_embeddings": True, "mlp_activation": "geglu"},
]


@pytest.mark.parametrize("variant", VARIANTS)
def test_transformer_forward_and_head_match_reference(micro, variant):
    ref_cfg, cfg, ref_params, flat = micro
    if variant:
        ref_cfg = dataclasses.replace(ref_cfg, **variant)
        cfg = dataclasses.replace(cfg, **variant)
        ref_params = ref_init_transformer(jax.random.PRNGKey(1), ref_cfg)
        flat = transformer_params_from_jax(jax.tree.map(np.asarray, ref_params), cfg)
    toks = np.random.default_rng(0).integers(0, LM_VOCAB, (3, 16)).astype(np.int32)
    want = ref_forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})[0]
    got = forward(flat, cfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    head = output_head(TransformerLayout(cfg).views(flat), cfg)
    np.testing.assert_array_equal(head.numpy(), np.asarray(ref_output_head(ref_params, ref_cfg)))


@pytest.mark.parametrize("variant", VARIANTS)
def test_transformer_cohort_forward_is_per_client(micro, variant):
    _, cfg, _, flat = micro
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
        flat = init_transformer(torch.Generator().manual_seed(1), cfg)
    cohort = torch.stack([flat, flat * 1.5, flat - 0.01])
    toks = _t(np.random.default_rng(2).integers(0, LM_VOCAB, (3, 2, 16)).astype(np.int32))
    got = forward(cohort, cfg, toks)
    for i in range(3):
        torch.testing.assert_close(got[i], forward(flat if i == 0 else cohort[i], cfg, toks[i]),
                                   atol=1e-5, rtol=0)


def test_transformer_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(_micro_cfgs()[1], d_model=64, d_ff=128, vocab=256)
    tree = TransformerLayout(cfg).views(init_transformer(torch.Generator().manual_seed(0), cfg))
    layer = tree["layers"][0]
    assert torch.equal(layer["norm1_scale"], torch.ones(64))
    assert torch.equal(layer["norm2_bias"], torch.zeros(64))
    for w, fan_in in [(layer["attn"]["wq"], 64), (layer["mlp"]["w_down"], 128),
                      (tree["head"], 64), (tree["embed"], 2500)]:
        assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.1


def test_transformer_rejects_what_the_slice_does_not_run():
    cfg = _micro_cfgs()[1]
    for change in ({"block_type": "xlstm"}, {"use_mla": True}, {"input_mode": "frames"},
                   {"dtype": "bfloat16"}):
        with pytest.raises(ValueError, match="repro_torch"):
            TransformerLayout(dataclasses.replace(cfg, **change))


# ---------------------------------------------------------------------------
# the LM task
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tasks(lm_data):
    ref_cfg = lm_fl_cfg()
    return ref_build_task(ref_cfg), build_task(FLConfig.from_dict(ref_cfg.to_dict()))


def test_lm_task_partition_and_features_are_exact(tasks, lm_data):
    ref_task, task = tasks
    train, _ = lm_data
    labels = task.partition_labels(train)
    np.testing.assert_array_equal(labels, ref_task.partition_labels(train))
    assert task.partition_classes(LM_VOCAB) == ref_task.partition_classes(LM_VOCAB) == 16
    idx = [np.arange(0, 48, 3), np.arange(1, 20), np.array([5, 47])]
    np.testing.assert_array_equal(task.client_features(train, idx, LM_VOCAB),
                                  ref_task.client_features(train, idx, LM_VOCAB))


@pytest.mark.parametrize("cohort", [False, True])
def test_lm_task_loss_metric_and_ppl_match_reference(tasks, lm_data, micro, cohort):
    ref_task, task = tasks
    _, cfg, ref_params, flat = micro
    train, test = lm_data
    r_apply, r_loss, r_metric = ref_task.build_fns(train, LM_VOCAB)
    apply_fn, loss_fn, metric_fn = task.build_fns(train, LM_VOCAB)
    if cohort:  # (m, P) weights, one per client, over (m, B, S) tokens
        x, y = train.x[:12].reshape(3, 4, 16), train.y[:12].reshape(3, 4, 16)
        params = torch.stack([flat] * 3)
        want_loss = np.array([r_loss(r_apply(ref_params, x[i]), y[i]) for i in range(3)])
        want_acc = np.array([r_metric(r_apply(ref_params, x[i]), y[i]) for i in range(3)])
    else:
        x, y, params = test.x, test.y, flat
        out = r_apply(ref_params, x)
        want_loss, want_acc = np.asarray(r_loss(out, y)), np.asarray(r_metric(out, y))
    ctx = apply_fn(params, _t(x))
    np.testing.assert_allclose(loss_fn(ctx, _t(y)).detach().numpy(), want_loss, atol=1e-5)
    np.testing.assert_allclose(metric_fn(ctx, _t(y)).numpy(), want_acc, atol=1e-5)
    if not cohort:
        got = task.build_eval_extra(test, LM_VOCAB)(flat, _t(test.x), _t(test.y))
        want = ref_task.build_eval_extra(test, LM_VOCAB)(ref_params, test.x, test.y)
        assert got["ppl_per_cluster"].keys() == want["ppl_per_cluster"].keys()
        np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-5)
        for t in want["ppl_per_cluster"]:
            np.testing.assert_allclose(got["ppl_per_cluster"][t], want["ppl_per_cluster"][t],
                                       rtol=1e-5)


def test_lm_config_validation():
    cfg = FLConfig.from_dict(lm_fl_cfg().to_dict())
    assert cfg.task == "lm" and FLConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="xlstm-125m"):
        FLConfig(task="lm")  # the reference's default model is not ported yet
    with pytest.raises(ValueError, match="invalid task_kwargs"):
        FLConfig(task="lm", task_kwargs={"model": "stablelm-3b", "bogus": 1})
    with pytest.raises(ValueError, match="invalid task_kwargs"):
        FLConfig(task="lm", task_kwargs={"model": "no-such-model"})


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def test_lm_rounds_match_reference(lm_data):
    """``lm_fl_cfg()`` for 2 rounds in the reference ``HostEngine`` and in the
    port on the CPU under the reference's draws."""
    train, test = lm_data
    ref_cfg = lm_fl_cfg()
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=LM_VOCAB)
    ref_res = list(ref_eng.rounds())
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, LM_VOCAB, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu"))
    res = list(eng.rounds())
    assert eng.n_params == ref_eng.n_params and eng.max_steps == ref_eng.max_steps
    np.testing.assert_array_equal(eng.strategy.labels, ref_eng.strategy.labels)
    assert len(res) == len(ref_res) == 2
    for r, w in zip(res, ref_res):
        assert r.selected == w.selected
        assert r.comm_mb == w.comm_mb
        assert abs(r.test_loss - w.test_loss) <= 1e-4
        assert abs(r.test_acc - w.test_acc) <= 1e-4
        assert abs(r.mean_selected_loss - w.mean_selected_loss) <= 1e-4
        assert abs(r.metrics["ppl"] - w.metrics["ppl"]) <= 1e-4
        assert r.metrics["ppl_per_cluster"].keys() == w.metrics["ppl_per_cluster"].keys()
    want = transformer_params_from_jax(jax.tree.map(np.asarray, ref_eng.params),
                                       eng.task.model_cfg).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, atol=1e-5)
    assert eng.history.keys() == ref_eng.history.keys()
    assert eng.history["selected"] == ref_eng.history["selected"]


def test_lm_partition_labels_override(lm_data):
    train, test = lm_data
    cfg = FLConfig.from_dict(lm_fl_cfg(rounds=1).to_dict())
    topics = np.arange(len(train.x)) % 4
    eng = make_engine(cfg, train, test, LM_VOCAB, device="cpu", partition_labels=topics)
    ref = ref_make_engine(lm_fl_cfg(rounds=1), train, test, LM_VOCAB, partition_labels=topics)
    for a, b in zip(eng.client_idx, ref.client_idx):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="partition_labels must be"):
        make_engine(cfg, train, test, LM_VOCAB, device="cpu", partition_labels=topics[:-1])
    with pytest.raises(ValueError, match="must lie in"):
        make_engine(cfg, train, test, LM_VOCAB, device="cpu", partition_labels=topics + 16)


def test_lm_torch_draws_run_is_deterministic(lm_data):
    train, test = lm_data
    cfg = FLConfig.from_dict(lm_fl_cfg().to_dict())
    a = make_engine(cfg, train, test, LM_VOCAB, device="cpu")
    b = make_engine(cfg, train, test, LM_VOCAB, device="cpu")
    ra, rb = list(a.rounds()), list(b.rounds())
    assert [r.selected for r in ra] == [r.selected for r in rb]
    assert torch.equal(a.params, b.params)
    for r in ra:
        assert np.isfinite(r.test_loss) and 0.0 <= r.test_acc <= 1.0
        assert np.isfinite(r.metrics["ppl"]) and r.metrics["ppl"] > 1.0
    assert a.history["round"] == [0, 1] and len(a.history["ppl"]) == 2


# ---------------------------------------------------------------------------
# hymba: attention in parallel with Mamba heads
# ---------------------------------------------------------------------------

# The reduced hymba config at micro width; its pattern "GL" makes layer 1 a
# sliding-window layer that bites at S = 16.
HYMBA_MICRO = {"model": "hymba-1.5b", "hist_bins": 16,
               "overrides": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                             "d_ff": 64, "vocab": LM_VOCAB, "loss_chunk": 16,
                             "attn_chunk": 16, "remat": False, "sliding_window": 8}}


def _hymba_cfgs(fuse=True):
    ov = {"dtype": "float32", **HYMBA_MICRO["overrides"]}
    ref = dataclasses.replace(ref_get_config("hymba-1.5b", reduced=True), **ov)
    ref = dataclasses.replace(ref, ssm=dataclasses.replace(ref.ssm, fuse_contraction=fuse))
    port = dataclasses.replace(get_config("hymba-1.5b", reduced=True), **ov)
    return ref, port


@pytest.fixture(scope="module")
def hymba():
    ref_cfg, cfg = _hymba_cfgs()
    ref_params = ref_init_transformer(jax.random.PRNGKey(0), ref_cfg)
    return cfg, ref_params, transformer_params_from_jax(jax.tree.map(np.asarray, ref_params), cfg)


def test_hymba_conversion_round_trips_exactly(hymba):
    cfg, ref_params, flat = hymba
    layout = TransformerLayout(cfg)
    assert flat.shape == (layout.n_params,) and flat.dtype == torch.float32
    layer = layout.views(flat)["layers"][1]
    assert set(layer) == {"norm1", "attn", "ssm", "attn_out_norm", "ssm_out_norm", "norm2", "mlp"}
    back = transformer_params_to_numpy(flat, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, ref_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.shape == b.shape and np.array_equal(a, np.asarray(b))
    assert torch.equal(transformer_params_from_jax(back, cfg), flat)


@pytest.mark.parametrize("fuse", [True, False])
def test_hymba_forward_matches_reference(hymba, fuse):
    """Both layouts of the reference's Mamba scan give the port's numbers."""
    cfg, ref_params, flat = hymba
    ref_cfg = _hymba_cfgs(fuse)[0]
    assert "".join("G" if g else "L" for g in layer_flags(cfg)["is_global"]) == "GL"
    toks = np.random.default_rng(3).integers(0, LM_VOCAB, (3, 16)).astype(np.int32)
    want = ref_forward(ref_params, ref_cfg, {"tokens": jnp.asarray(toks)})[0]
    got = forward(flat, cfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_hymba_cohort_forward_is_per_client(hymba):
    cfg, _, flat = hymba
    cohort = torch.stack([flat, flat * 1.5, flat - 0.01])
    toks = _t(np.random.default_rng(4).integers(0, LM_VOCAB, (3, 2, 16)).astype(np.int32))
    got = forward(cohort, cfg, toks)
    for i in range(3):
        torch.testing.assert_close(got[i], forward(cohort[i].clone(), cfg, toks[i]),
                                   atol=1e-5, rtol=0)


def test_hymba_lm_rounds_match_reference(lm_data):
    """2 rounds of ``lm_fl_cfg`` on the hymba micro config in the reference
    ``HostEngine`` and in the port on the CPU under the reference's draws."""
    train, test = lm_data
    ref_cfg = lm_fl_cfg(task_kwargs=HYMBA_MICRO)
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=LM_VOCAB)
    ref_res = list(ref_eng.rounds())
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, LM_VOCAB, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu"))
    res = list(eng.rounds())
    assert eng.task.model_cfg.block_type == "hymba"
    assert eng.n_params == ref_eng.n_params and eng.max_steps == ref_eng.max_steps
    assert len(res) == len(ref_res) == 2
    for r, w in zip(res, ref_res):
        assert r.selected == w.selected
        assert r.comm_mb == w.comm_mb
        assert abs(r.test_loss - w.test_loss) <= 1e-4
        assert abs(r.test_acc - w.test_acc) <= 1e-4
        assert abs(r.mean_selected_loss - w.mean_selected_loss) <= 1e-4
        assert abs(r.metrics["ppl"] - w.metrics["ppl"]) <= 1e-4
    want = transformer_params_from_jax(jax.tree.map(np.asarray, ref_eng.params),
                                       eng.task.model_cfg).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, atol=1e-5)
