"""Port parity for the serving path: the same numpy inputs and the
reference's own weights and state go through the JAX package and the
port on the CPU.

- ``rope_table`` rows at a position, and the norms and RoPE on bf16 inputs
  (fp32 inside, the input's type out);
- ``decode_attention`` and ``gqa_decode`` against the reference, with a
  window smaller than the prompt so that it bites;
- ``mamba_seq``'s final state and conv tail and ``mamba_decode``;
  ``mlstm_seq`` / ``slstm_seq`` states and ``mlstm_decode`` /
  ``slstm_decode``;
- ``prefill`` and two ``decode_step`` calls of micro models of every
  served family (qwen3's qk-norm, gemma3's tied embedding, geglu, dual
  RoPE theta and window, stablelm's LayerNorm and partial RoPE, hymba,
  xlstm with an mLSTM and an sLSTM layer) from the reference's parameters
  (``serving_params_from_jax``), logits and caches leaf for leaf, at fp32
  and at bf16;
- the contract of ``tests/test_arch_smoke.py``: decode(prefill(x[:-1]),
  x[-1]) equals forward(x) at the last position;
- ``BatchScheduler`` against the reference's on qwen3-14b reduced, and
  ``repro_torch.launch.serve.main`` in process;
- ``dummy_batch`` and ``dummy_decode_batch`` draw the reference's tokens.

Tolerances.  fp32: 1e-5 for attention, the Mamba and xLSTM blocks and
every cache leaf, 1e-4 for logits, relative to max(1, max |reference|)
(sums and exps in another order than XLA's), and greedy tokens exactly.
bf16: the reference rounds at other places than PyTorch (XLA keeps excess
precision inside a fusion; PyTorch rounds each op's output to bf16), so
one bf16 rounding (2^-8 relative) separates them per op, and two layers
compound it: 3e-2 relative to max(1, max |reference|) for logits and
every cache leaf (the largest seen: 1.3e-2, hymba's logits); tokens are
not compared at bf16 (``argmax`` of near-tied bf16 logits).  The
prefill -> decode contract holds the reference's own 2e-2 x (max |logit|
+ 1)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import inputs as ref_inputs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import BatchScheduler as RefBatchScheduler  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import inputs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    cache_from_jax,
    cache_to_numpy,
    serving_params_from_jax,
)
from repro_torch.models import attention, common, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import BatchScheduler  # noqa: E402

S = 12          # prompt length: past the micro configs' 4-token window
TINY = {"d_model": 64, "head_dim": 16, "d_ff": 128, "vocab": 64}
FAMILIES = {    # name -> (registered model, overrides of its reduced config)
    "qwen3": ("qwen3-14b", {}),
    "gemma3": ("gemma3-27b", {"layer_pattern": "LG", "sliding_window": 4}),
    "stablelm": ("stablelm-3b", {}),
    "hymba": ("hymba-1.5b", {"sliding_window": 4}),
    "xlstm": ("xlstm-125m", {"layer_pattern": "MS"}),
}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().to(torch.float32) if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


def _cfgs(family, dtype="float32"):
    model, extra = FAMILIES[family]
    kw = {**TINY, **extra, "dtype": dtype}
    return (dataclasses.replace(ref_get_config(model, reduced=True), **kw),
            dataclasses.replace(get_config(model, reduced=True), **kw))


# ---------------------------------------------------------------------------
# norms, RoPE, attention
# ---------------------------------------------------------------------------


def test_rope_rows_and_bf16_norms_match_reference():
    sin, cos = common.rope_table(20, 8, 1e4)
    row = common.rope_table(20, 8, 1e4, positions=13)
    assert torch.equal(row[0], sin[13:14]) and torch.equal(row[1], cos[13:14])
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 3, 16)).astype(np.float32)
    scale, bias = rng.normal(0, 0.1, 16).astype(np.float32), rng.normal(0, 0.1, 16)
    xb, xj = _t(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    sj, cj = ref_common.rope_table(5, 8, 1e4)
    for got, want in [
        (common.rms_norm(xb, _t(scale)), ref_common.rms_norm(xj, jnp.asarray(scale))),
        (common.layer_norm(xb, _t(scale), _t(bias).float()),
         ref_common.layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias, jnp.float32))),
        (common.apply_rope(xb, _t(sj), _t(cj), 0.5), ref_common.apply_rope(xj, sj, cj, 0.5)),
    ]:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        # fp32 inside, one rounding to bf16 on either side
        _close(got, np.asarray(want, np.float32), 2 ** -7)


@pytest.mark.parametrize("window,is_global", [(0, 1.0), (5, 0.0), (5, 1.0)])
def test_decode_attention_matches_reference(window, is_global):
    rng = np.random.default_rng(1)
    b, s, h, kv, d, pos = 2, 16, 4, 2, 8, 11
    q = rng.normal(0, 1, (b, 1, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, d)).astype(np.float32)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.int32(pos), window, is_global)
    got = attention.decode_attention(_t(q), _t(k), _t(v), pos, window, is_global)
    _close(got, want, 1e-5)
    # entries past pos do not count
    k2, v2 = k.copy(), v.copy()
    k2[:, pos + 1:], v2[:, pos + 1:] = 99.0, -99.0
    _close(attention.decode_attention(_t(q), _t(k2), _t(v2), pos, window, is_global), want, 1e-5)


@pytest.mark.parametrize("qk_norm,rope_fraction", [(False, 1.0), (True, 0.5)])
def test_gqa_decode_matches_reference_and_full_pass(qk_norm, rope_fraction):
    """Each position decoded from the cache, the window (4) shorter than the
    prompt (12), against the reference's ``gqa_decode`` step by step (out
    and cache) and the port's full pass (out, and its k and v)."""
    kw = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=50, dtype="float32", qk_norm=qk_norm, rope_fraction=rope_fraction,
              sliding_window=4)
    ref_cfg = ref_get_config("qwen3-14b").__class__(**kw)
    cfg = get_config("qwen3-14b").__class__(**kw)
    ref_p = ref_attn.init_gqa(jax.random.PRNGKey(0), ref_cfg)
    ref_p = {**ref_p, **{n: 0.1 * jax.random.normal(jax.random.PRNGKey(1), ref_p[n].shape)
                         for n in ("q_norm", "k_norm") if n in ref_p}}
    p = {n: _t(a) for n, a in ref_p.items()}
    x = np.random.default_rng(2).normal(0, 1, (2, S, 32)).astype(np.float32)
    hd = cfg.resolved_head_dim
    rot = max(int(hd * rope_fraction) - int(hd * rope_fraction) % 2, 2)
    sin, cos = common.rope_table(S, rot, cfg.rope_theta)
    full, (k_full, v_full) = attention.gqa_attention(p, cfg, _t(x), sin, cos, 0.0)
    cache = (torch.zeros(2, S, 2, hd), torch.zeros(2, S, 2, hd))
    ref_cache = (jnp.zeros((2, S, 2, hd)), jnp.zeros((2, S, 2, hd)))
    ref_sin, ref_cos = ref_common.rope_table(S, rot, ref_cfg.rope_theta)
    for t in range(S):
        row = common.rope_table(S, rot, cfg.rope_theta, positions=t)
        out, cache = attention.gqa_decode(p, cfg, _t(x[:, t:t + 1]), *row, cache, t, 0.0)
        want, ref_cache = ref_attn.gqa_decode(ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]),
                                              ref_sin[t:t + 1], ref_cos[t:t + 1], ref_cache,
                                              t, 0.0)
        _close(out, want, 1e-5, f"out {t}")
        _close(out[:, 0], full[:, t].detach(), 1e-5, f"full pass {t}")
    for got, want, full_kv in zip(cache, ref_cache, (k_full, v_full)):
        _close(got, want, 1e-5, "cache")
        _close(got, full_kv, 1e-5, "cache vs the full pass")


# ---------------------------------------------------------------------------
# Mamba and xLSTM states
# ---------------------------------------------------------------------------


def _block(family, init, seed):
    ref_cfg, cfg = _cfgs(family)
    ref_p = init(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, ref_p, {n: _t(a) for n, a in ref_p.items()}


@pytest.mark.parametrize("s", [S, 2])   # 2: shorter than the conv's 3-row tail
def test_mamba_seq_state_and_decode_match_reference(s):
    ref_cfg, cfg, ref_p, p = _block("hymba", ref_ssm.init_mamba, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, s + 3, 64)).astype(np.float32)
    want, (ref_h, ref_tail) = ref_ssm.mamba_seq(ref_p, ref_cfg, jnp.asarray(x[:, :s]))
    got, (h, tail) = ssm.mamba_seq(p, cfg, _t(x[:, :s]))
    _close(got, want, 1e-5, "out")
    _close(h, ref_h, 1e-5, "h")
    _close(tail, ref_tail, 0.0, "conv tail")
    for t in range(s, s + 3):
        want, (ref_h, ref_tail) = ref_ssm.mamba_decode(ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]),
                                                       ref_h, ref_tail)
        got, (h, tail) = ssm.mamba_decode(p, cfg, _t(x[:, t:t + 1]), h, tail)
        _close(got, want, 1e-5, f"decode out {t}")
        _close(h, ref_h, 1e-5, f"decode h {t}")
        _close(tail, ref_tail, 0.0, f"decode tail {t}")


@pytest.mark.parametrize("core", ["mlstm", "slstm"])
def test_xlstm_states_and_decode_match_reference(core):
    ref_cfg, cfg, ref_p, p = _block("xlstm", ref_ssm.init_xlstm, 5)
    ref_p = {**ref_p, "core_norm": 0.1 * jax.random.normal(jax.random.PRNGKey(6), (64,))}
    p["core_norm"] = _t(ref_p["core_norm"])
    x = np.random.default_rng(7).normal(0, 1, (2, S + 3, 64)).astype(np.float32)
    ref_seq, ref_step = getattr(ref_ssm, f"{core}_seq"), getattr(ref_ssm, f"{core}_decode")
    seq, step = getattr(ssm, f"{core}_seq"), getattr(ssm, f"{core}_decode")
    want, ref_state = ref_seq(ref_p, ref_cfg, jnp.asarray(x[:, :S]))
    got, state = seq(p, cfg, _t(x[:, :S]))
    _close(got, want, 1e-5, "out")
    for g, w in zip(state, ref_state):
        _close(g, w, 1e-5, "state")
    for t in range(S, S + 3):
        want, ref_state = ref_step(ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]), ref_state)
        got, state = step(p, cfg, _t(x[:, t:t + 1]), state)
        _close(got, want, 1e-5, f"decode out {t}")
        for g, w in zip(state, ref_state):
            _close(g, w, 1e-5, f"decode state {t}")


# ---------------------------------------------------------------------------
# the model: prefill, decode_step, the prefill -> decode contract
# ---------------------------------------------------------------------------


def _check_cache(cache, ref_cache, dtype, what):
    got, want = cache_to_numpy(cache), ref_cache
    assert set(got) == set(want), (set(got), set(want))
    for name in want:
        pairs = zip(got[name], want[name]) if isinstance(want[name], tuple) else \
            [(got[name], want[name])]
        for g, w in pairs:
            _close(g, np.asarray(w, np.float32), CACHE_TOL[dtype], f"{what} cache {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_step_match_reference(family, dtype):
    ref_cfg, cfg = _cfgs(family, dtype)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    assert all(a.dtype == (torch.float32 if a.ndim == 1 else getattr(torch, dtype))
               for a in (p["embed"], p["final_norm"] if "final_norm" in p
                         else p["final_norm_scale"]))
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, S + 2)).astype(np.int32)
    max_len = S + 4
    want, ref_cache = ref_tf.prefill(ref_p, ref_cfg, {"tokens": jnp.asarray(toks[:, :S])},
                                     max_len=max_len)
    got, cache = tf.prefill(p, cfg, {"tokens": _t(toks[:, :S])}, max_len)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, LOGITS_TOL[dtype], "prefill logits")
    _check_cache(cache, ref_cache, dtype, "prefill")
    # decode from the reference's own cache as well: the step alone
    ref_step = jax.jit(lambda pp, b, c, pos: ref_tf.decode_step(pp, ref_cfg, b, c, pos))
    own = cache_from_jax(jax.tree.map(np.asarray, ref_cache), cfg)
    for j, pos in enumerate((S, S + 1)):
        tok = toks[:, S + j:S + j + 1]
        want, ref_cache = ref_step(ref_p, {"token": jnp.asarray(tok)}, ref_cache, jnp.int32(pos))
        got, cache = tf.decode_step(p, cfg, {"token": _t(tok)}, cache, pos)
        step, own = tf.decode_step(p, cfg, {"token": _t(tok)}, own, pos)
        _close(got, want, LOGITS_TOL[dtype], f"decode logits {pos}")
        _close(step, want, LOGITS_TOL[dtype], f"decode logits {pos} from the reference cache")
        _check_cache(cache, ref_cache, dtype, f"decode {pos}")
        if dtype == "float32":
            np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_then_decode_matches_forward(family, dtype):
    _, cfg = _cfgs(family, dtype)
    p = tf.init_params(torch.Generator().manual_seed(1), cfg)
    toks = inputs.dummy_batch(cfg, 2, S, seed=2)["tokens"]
    want = tf._logits(p, cfg, tf.forward(p, cfg, toks)[:, -1])
    _, cache = tf.prefill(p, cfg, {"tokens": toks[:, :-1]}, S + 4)
    got, _ = tf.decode_step(p, cfg, {"token": toks[:, -1:]}, cache, S - 1)
    scale = float(want.float().abs().max()) + 1.0
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * scale


def test_init_params_keeps_the_references_fp32_leaves():
    for family in ("hymba", "xlstm", "stablelm"):
        ref_cfg, cfg = _cfgs(family, "bfloat16")
        ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
        p = tf.init_params(torch.Generator().manual_seed(0), cfg)
        ref_types = {jax.tree_util.keystr(k): v.dtype for k, v in
                     jax.tree_util.tree_flatten_with_path(ref_p)[0]}
        layer = p["layers"][0]
        for key, leaf in [*((k, v) for k, v in p.items() if k != "layers"),
                          *(("['layers']" + k, v) for k, v in _flat(layer).items())]:
            name = key if key.startswith("['layers']") else f"['{key}']"
            assert str(leaf.dtype).removeprefix("torch.") == str(ref_types[name]), name
    with pytest.raises(ValueError, match="trains in float32"):
        tf.TransformerLayout(cfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


# ---------------------------------------------------------------------------
# the scheduler, the CLI, the inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    ref_cfg = ref_get_config("qwen3-14b", reduced=True)
    cfg = get_config("qwen3-14b", reduced=True)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    return ref_cfg, cfg, ref_p, serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)


def test_scheduler_drains_mixed_lengths_as_the_reference(served):
    ref_cfg, cfg, ref_p, p = served
    sched = BatchScheduler(cfg, p, max_batch=3, max_new=4)
    ref_sched = RefBatchScheduler(ref_cfg, ref_p, max_batch=3, max_new=4)
    rng = np.random.default_rng(0)
    ids = []
    for plen in (16, 16, 16, 16, 24, 24):   # two buckets, one underfull group
        prompt = rng.integers(0, cfg.vocab, plen)
        ids.append(sched.submit(prompt))
        assert ref_sched.submit(prompt) == ids[-1]
    assert sched.pending() == 6
    assert sched.run() == 6 and sched.pending() == 0
    ref_sched.run()
    for rid in ids:
        out = sched.result(rid)
        assert out.shape == (4,) and out.dtype == np.int32
        np.testing.assert_array_equal(out, ref_sched.result(rid))


def test_scheduler_matches_unbatched_decode(served):
    _, cfg, _, p = served
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 16).astype(np.int32)
    sched = BatchScheduler(cfg, p, max_batch=4, max_new=5)
    rid = sched.submit(prompt)
    sched.run()
    logits, cache = tf.prefill(p, cfg, {"tokens": _t(prompt[None])}, 16 + 5)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    want = [int(tok[0, 0])]
    for i in range(4):
        logits, cache = tf.decode_step(p, cfg, {"token": tok}, cache, 16 + i)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        want.append(int(tok[0, 0]))
    np.testing.assert_array_equal(sched.result(rid), np.array(want))


def test_scheduler_eos_truncates_and_unfinished_raises(served):
    _, cfg, _, p = served
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 8).astype(np.int32)
    probe = BatchScheduler(cfg, p, max_batch=1, max_new=3)
    rid = probe.submit(prompt)
    probe.run()
    first = int(probe.result(rid)[0])
    sched = BatchScheduler(cfg, p, max_batch=1, max_new=6, eos_id=first)
    rid = sched.submit(prompt)
    sched.run()
    out = sched.result(rid)
    np.testing.assert_array_equal(out, [first])
    pending = BatchScheduler(cfg, p, max_batch=2, max_new=2)
    rid = pending.submit(np.zeros(8, np.int32))
    with pytest.raises(RuntimeError, match="not finished"):
        pending.result(rid)


def test_serve_cli_in_process(capsys, monkeypatch):
    from repro_torch.launch import serve

    gen = serve.main(["--arch", "qwen3-14b", "--reduced", "--batch", "2", "--prompt-len", "32",
                      "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2×32" in out and "decoded 4 tokens × 2 seqs" in out and "tok/s" in out
    assert gen.shape == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-14b", "--reduced"])


def test_dummy_batches_match_reference():
    ref_cfg, cfg = ref_get_config("qwen3-14b", reduced=True), get_config("qwen3-14b", reduced=True)
    want, got = ref_inputs.dummy_batch(ref_cfg, 3, 7, seed=5), inputs.dummy_batch(cfg, 3, 7, seed=5)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(inputs.dummy_decode_batch(cfg, 3, seed=5)["token"].numpy(),
                                  np.asarray(ref_inputs.dummy_decode_batch(ref_cfg, 3, seed=5)
                                             ["token"]))
    assert inputs.long_context_variant(cfg) == dataclasses.replace(
        cfg, name=cfg.name + "+swa4k", sliding_window=4096, layer_pattern="L")
    assert inputs.long_context_variant(get_config("hymba-1.5b")) == get_config("hymba-1.5b")
