"""Port parity for the MoE and MLA blocks (dbrx-132b, deepseek-v3-671b): the
same numpy-seeded inputs and the reference's own weights go through the
JAX package and the port on the CPU.

- ``init_moe`` / ``init_mla``: shapes and types against the reference's, at
  bf16 (the router and the norm scales stay fp32);
- ``_router``: expert ids exactly, weights and aux loss within 1e-6;
- ``moe_dense``'s output and its gradient (``jax.vjp``), the blocked walk
  over the experts against the unblocked one, per-client weights against
  one model a client;
- ``mla_attention`` (the flash-attention kernel's plain version on the
  zero-padded values) and its gradient, and ``mla_decode`` with its cache;
- the reduced dbrx and deepseek configs: ``prefill`` and two
  ``decode_step`` calls against the reference's, and decode(prefill(
  x[:-1]), x[-1]) = forward(x) at the last position;
- one federated round of micro dbrx, and of micro deepseek without its
  MTP head, against the reference ``HostEngine`` under ``JaxReplayDraws``;
- ``launch.serve`` on reduced dbrx.

Tolerances: 1e-6 for the router (fp32 softmax and a division); 1e-5 for
the blocks, their gradients and the caches, whose fp32 sums run in another
order (XLA's contractions against PyTorch's, and the port's expert blocks
summed one after another), relative to max(1, max |reference|); 1e-4 for
logits; the round as the other LM slices (1e-4 on the metrics, 1e-5 on
the parameters).  The prefill -> decode contract holds the reference's
2e-2 x (max |logit| + 1), here met within 1e-4."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import LM_VOCAB, lm_fl_cfg  # noqa: E402
from test_torch_engine import JaxReplayDraws  # noqa: E402
from test_torch_serving import _check_cache, _close  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.engine import make_engine as ref_make_engine  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    cache_from_jax,
    serving_params_from_jax,
    transformer_params_from_jax,
)
from repro_torch.engine import FLConfig, make_engine  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import rope_table  # noqa: E402

MODELS = {"dbrx": "dbrx-132b", "deepseek": "deepseek-v3-671b"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(family, **kw):
    name = MODELS[family]
    return (dataclasses.replace(ref_get_config(name, reduced=True), **kw),
            dataclasses.replace(get_config(name, reduced=True), **kw))


def _types(tree):
    return {jax.tree_util.keystr(k): str(v.dtype)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", list(MODELS))
def test_init_moe_and_mla_shapes_and_types_match_reference(family):
    """The reference's shapes and types come from ``jax.eval_shape`` (its
    init traced, not run)."""
    ref_cfg, cfg = _cfgs(family, dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    ref_p = jax.eval_shape(lambda: ref_moe.init_moe(key, ref_cfg))
    p = moe.init_moe(g, cfg, torch.bfloat16)
    assert sorted(p) == sorted(ref_p)
    for k in p:
        assert p[k].shape == ref_p[k].shape and str(p[k].dtype)[6:] == str(ref_p[k].dtype), k
    assert p["router"].dtype == torch.float32
    if cfg.use_mla:
        ref_a = jax.eval_shape(lambda: ref_attn.init_mla(key, ref_cfg))
        a = tf.cast_params(attention.init_mla(g, cfg), torch.bfloat16)
        assert sorted(a) == sorted(ref_a)
        for k in a:
            assert a[k].shape == ref_a[k].shape and str(a[k].dtype)[6:] == str(ref_a[k].dtype), k
    ref_types = _types(jax.eval_shape(lambda: ref_tf.init_transformer(key, ref_cfg)))
    tree = tf.init_params(torch.Generator().manual_seed(0), cfg)
    got = _flat({**tree, "layers": tree["layers"][0]})
    assert got == ref_types


def _flat(tree, prefix=""):
    """{"['a']['b']": dtype name} of a tree of dicts, as ``_types`` keys the
    reference's (whose layer leaves are stacked under ``['layers']``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _flat(v, f"{prefix}[{k!r}]")
        else:
            out[f"{prefix}[{k!r}]"] = str(v.dtype).removeprefix("torch.")
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def moe_block(request):
    """The reduced config's MoE block from the reference's init, and 2 x 16
    tokens of normal inputs."""
    ref_cfg, cfg = _cfgs(request.param)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(1), ref_cfg)
    p = {k: _t(v) for k, v in ref_p.items()}
    x = np.random.default_rng(2).normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, ref_p, p, x


def test_router_matches_reference(moe_block):
    ref_cfg, cfg, ref_p, p, x = moe_block
    x2d = x.reshape(-1, cfg.d_model)
    ids, w, aux = ref_moe._router(ref_p, ref_cfg, jnp.asarray(x2d))
    got_ids, got_w, got_aux = moe._router(p, cfg, _t(x2d))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    assert abs(float(got_aux) - float(aux)) <= 1e-6 * max(1.0, abs(float(aux)))


def test_moe_dense_and_gradient_match_reference(moe_block):
    ref_cfg, cfg, ref_p, p, x = moe_block
    g = np.random.default_rng(3).normal(0, 1, x.shape).astype(np.float32)
    (out, aux), vjp = jax.vjp(lambda pp, xx: ref_moe.moe_dense(pp, ref_cfg, xx), ref_p,
                              jnp.asarray(x))
    want_p, want_x = vjp((jnp.asarray(g), jnp.ones_like(aux)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = _t(x).requires_grad_(True)
    got, got_aux = moe.moe_dense(leaves, cfg, xt)
    _close(got, out, 1e-5, "out")
    assert abs(float(got_aux.detach()) - float(aux)) <= 1e-6
    grads = torch.autograd.grad((got * _t(g)).sum() + got_aux, [xt, *leaves.values()])
    _close(grads[0], want_x, 1e-5, "dx")
    for (k, _), gk in zip(leaves.items(), grads[1:]):
        _close(gk, want_p[k], 1e-5, f"d{k}")


def test_moe_blocked_walk_matches_the_unblocked_one(moe_block, monkeypatch):
    """Blocks of 1 and 3 experts (``_BLOCK_BYTES`` cut to fit them) against
    all experts in one block."""
    _, cfg, _, p, x = moe_block
    per_expert = x.shape[0] * x.shape[1] * (2 * cfg.moe.d_expert + cfg.d_model) * 4
    outs = []
    for budget in (1, 3 * per_expert, 1 << 40):
        monkeypatch.setattr(moe, "_BLOCK_BYTES", budget)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        out, aux = moe.moe_dense(leaves, cfg, _t(x))
        grads = torch.autograd.grad(out.square().sum() + aux, list(leaves.values()))
        outs.append((out.detach(), aux.detach(), grads))
    for out, aux, grads in outs[:-1]:
        _close(out, outs[-1][0].numpy(), 1e-5, "out")
        torch.testing.assert_close(aux, outs[-1][1], atol=0, rtol=0)
        for a, b in zip(grads, outs[-1][2]):
            _close(a, b.numpy(), 1e-5, "grad")


def test_moe_dense_takes_per_client_weights(moe_block):
    """(m, ...) weights and tokens (m, B, S, d) give each client's own
    output and its own aux loss over its B x S tokens."""
    _, cfg, _, p, x = moe_block
    cohort = {k: torch.stack([v, v * 1.5, v - 0.01]) for k, v in p.items()}
    xs = _t(np.stack([x, x[::-1].copy(), x * 0.5]))
    out, aux = moe.moe_dense(cohort, cfg, xs)
    assert out.shape == xs.shape and aux.shape == (3,)
    for i in range(3):
        want, want_aux = moe.moe_dense({k: v[i] for k, v in cohort.items()}, cfg, xs[i])
        torch.testing.assert_close(out[i], want, atol=1e-5, rtol=0)
        torch.testing.assert_close(aux[i], want_aux, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def mla_block():
    """The reduced MLA block; the reference attends with its exact
    ``naive_attention`` (its chunked scan gives the same numbers within
    fp32 rounding and takes longer to trace)."""
    ref_cfg, cfg = _cfgs("deepseek", sliding_window=0, attn_impl="naive")
    ref_p = ref_attn.init_mla(jax.random.PRNGKey(4), ref_cfg)
    p = {k: _t(v) for k, v in ref_p.items()}
    return ref_cfg, cfg, ref_p, p


def test_mla_attention_and_gradient_match_reference(mla_block):
    ref_cfg, cfg, ref_p, p = mla_block
    s = 24
    x = np.random.default_rng(5).normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    g = np.random.default_rng(6).normal(0, 1, x.shape).astype(np.float32)
    ref_sin, ref_cos = ref_tf._rope_tables(ref_cfg, s)[0]
    (out, (lat, kr)), vjp = jax.vjp(
        jax.jit(lambda pp, xx: ref_attn.mla_attention(pp, ref_cfg, xx, ref_sin, ref_cos)),
        ref_p, jnp.asarray(x))
    want_p, want_x = vjp((jnp.asarray(g), (jnp.zeros_like(lat), jnp.zeros_like(kr))))
    sin, cos = rope_table(s, cfg.qk_rope_head_dim, cfg.rope_theta)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = _t(x).requires_grad_(True)
    got, (got_lat, got_kr) = attention.mla_attention(leaves, cfg, xt, sin, cos)
    _close(got, out, 1e-5, "out")
    _close(got_lat, lat, 1e-5, "latent")
    _close(got_kr, kr, 1e-5, "k_rope")
    grads = torch.autograd.grad((got * _t(g)).sum(), [xt, *leaves.values()])
    _close(grads[0], want_x, 1e-5, "dx")
    for (k, _), gk in zip(leaves.items(), grads[1:]):
        _close(gk, want_p[k], 1e-5, f"d{k}")


def test_mla_decode_matches_reference(mla_block):
    ref_cfg, cfg, ref_p, p = mla_block
    b, smax, pos = 2, 10, 6
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (b, 1, cfg.d_model)).astype(np.float32)
    lat = rng.normal(0, 1, (b, smax, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(0, 1, (b, smax, cfg.qk_rope_head_dim)).astype(np.float32)
    (ref_sin, ref_cos), _ = ref_tf._rope_tables(ref_cfg, smax, positions=pos)
    out, (ref_lat, ref_kr) = jax.jit(
        lambda pp, xx, c: ref_attn.mla_decode(pp, ref_cfg, xx, ref_sin, ref_cos, c, pos))(
        ref_p, jnp.asarray(x), (jnp.asarray(lat), jnp.asarray(kr)))
    sin, cos = rope_table(smax, cfg.qk_rope_head_dim, cfg.rope_theta, positions=pos)
    cache = (_t(lat), _t(kr))
    got, (got_lat, got_kr) = attention.mla_decode(p, cfg, _t(x), sin, cos, cache, pos)
    assert got_lat is cache[0] and got_kr is cache[1]   # written in place
    _close(got, out, 1e-5, "out")
    _close(got_lat, ref_lat, 1e-5, "latent cache")
    _close(got_kr, ref_kr, 1e-5, "k_rope cache")


S = 12


@pytest.mark.parametrize("family", list(MODELS))
def test_prefill_and_decode_step_match_reference(family):
    ref_cfg, cfg = _cfgs(family)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, S + 2)).astype(np.int32)
    max_len = S + 4
    want, ref_cache = ref_tf.prefill(ref_p, ref_cfg, {"tokens": jnp.asarray(toks[:, :S])},
                                     max_len=max_len)
    got, cache = tf.prefill(p, cfg, {"tokens": _t(toks[:, :S])}, max_len)
    _close(got, want, 1e-4, "prefill logits")
    _check_cache(cache, ref_cache, "float32", "prefill")
    own = cache_from_jax(jax.tree.map(np.asarray, ref_cache), cfg)
    for j, pos in enumerate((S, S + 1)):
        tok = toks[:, S + j:S + j + 1]
        want, ref_cache = ref_tf.decode_step(ref_p, ref_cfg, {"token": jnp.asarray(tok)},
                                             ref_cache, jnp.int32(pos))
        got, cache = tf.decode_step(p, cfg, {"token": _t(tok)}, cache, pos)
        step, own = tf.decode_step(p, cfg, {"token": _t(tok)}, own, pos)
        _close(got, want, 1e-4, f"decode logits {pos}")
        _close(step, want, 1e-4, f"decode logits {pos} from the reference cache")
        _check_cache(cache, ref_cache, "float32", f"decode {pos}")
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("family", list(MODELS))
def test_prefill_then_decode_matches_forward(family):
    cfg = get_config(MODELS[family], reduced=True)
    p = tf.init_params(torch.Generator().manual_seed(1), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, S)).astype(np.int32))
    want = tf._logits(p, cfg, tf.forward(p, cfg, toks)[:, -1])
    _, cache = tf.prefill(p, cfg, {"tokens": toks[:, :-1]}, S + 4)
    got, _ = tf.decode_step(p, cfg, {"token": toks[:, -1:]}, cache, S - 1)
    scale = float(want.abs().max()) + 1.0
    assert float((got - want).abs().max()) <= 1e-4 * scale


# micro widths of the two families for the federated round: lm_fl_cfg's
# attention widths, the reduced MoE (4 experts, top 2), MLA ranks of 16
MICRO = {
    "dbrx": {"model": "dbrx-132b", "hist_bins": 16, "overrides": {
        **lm_fl_cfg().task_kwargs["overrides"]}},
    "deepseek": {"model": "deepseek-v3-671b", "hist_bins": 16, "overrides": {
        **lm_fl_cfg().task_kwargs["overrides"], "mtp": False, "q_lora_rank": 16,
        "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16}},
}


@pytest.mark.parametrize("family", list(MODELS))
def test_lm_round_matches_reference(lm_data, family):
    """One round of ``lm_fl_cfg`` on the micro MoE config in the reference
    ``HostEngine`` and in the port on the CPU under the reference's draws:
    the poll's losses (with the router's aux term) rank the clients."""
    train, test = lm_data
    ref_cfg = lm_fl_cfg(task_kwargs=MICRO[family], rounds=1)
    ref_eng = ref_make_engine(ref_cfg, train, test, n_classes=LM_VOCAB)
    ref_res = list(ref_eng.rounds())
    cfg = FLConfig.from_dict(ref_cfg.to_dict())
    eng = make_engine(cfg, train, test, LM_VOCAB, device="cpu",
                      draws=JaxReplayDraws(cfg.seed, "cpu"))
    res = list(eng.rounds())
    assert eng.task.model_cfg.moe is not None
    assert eng.n_params == ref_eng.n_params and eng.max_steps == ref_eng.max_steps
    for r, w in zip(res, ref_res, strict=True):
        assert r.selected == w.selected
        assert r.comm_mb == w.comm_mb
        assert abs(r.test_loss - w.test_loss) <= 1e-4
        assert abs(r.test_acc - w.test_acc) <= 1e-4
        assert abs(r.mean_selected_loss - w.mean_selected_loss) <= 1e-4
        assert abs(r.metrics["ppl"] - w.metrics["ppl"]) <= 1e-4
    want = transformer_params_from_jax(jax.tree.map(np.asarray, ref_eng.params),
                                       eng.task.model_cfg).numpy()
    np.testing.assert_allclose(eng.params.numpy(), want, atol=1e-5)


def test_lm_task_rejects_the_mtp_head():
    from repro_torch.engine.tasks import build_task

    with pytest.raises(ValueError, match="MTP aux loss"):
        build_task(FLConfig(task="lm", task_kwargs={"model": "deepseek-v3-671b"}))


def test_serve_cli_on_reduced_dbrx(capsys):
    from repro_torch.launch import serve

    gen = serve.main(["--arch", "dbrx-132b", "--reduced", "--batch", "2", "--prompt-len", "16",
                      "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2×16" in out and "decoded 3 tokens × 2 seqs" in out
    assert gen.shape == (2, 3) and int(gen.max()) < get_config("dbrx-132b", reduced=True).vocab
