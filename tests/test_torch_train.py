"""Port parity for the training launcher (``repro_torch.launch.train``): the
reference's weights and the same numpy-seeded token stream go through the
JAX package and the port on the CPU.

- ``loss_fn`` and its gradient against ``jax.value_and_grad(loss_fn)`` on
  the reduced stablelm, hymba, xlstm, dbrx and deepseek configs (deepseek
  with its MTP head);
- 3 steps of ``make_train_step`` with the launcher's optimizer against the
  reference's on reduced fp32 stablelm and dbrx; a step of xlstm with an
  sLSTM layer (the leaves a layer does not use take a zero gradient);
- one bf16 step on reduced stablelm (``dtype`` overridden), the gradients
  in each leaf's type and AdamW's moments in fp32;
- the CLI through ``subprocess`` with ``--device cpu``, and its refusal to
  run on the CPU without it when there is no card;
- ``--resume`` from a checkpoint of step 3 bit-identical to an
  uninterrupted 6-step run, ``--ckpt``'s file holding the run's state, and
  a checkpoint of another arch refused with the reference's message.

Tolerances, relative to max(1, max |reference|) of each leaf: 1e-5 for the
fp32 losses and the MoE aux term, 1e-4 for the gradients (fp32 sums over
the batch and the sequence in another order than XLA's, through two
layers), 1e-5 for the parameters after 3 AdamW steps (the updates are at
most the learning rate, 3e-4 x 2 / 10 in the warmup, so gradient noise
moves them little).  bf16: 2e-3 on the loss (bf16 rounding of activations
at other places than XLA's) and, after one AdamW step, each parameter
within 2 lr plus one bf16 unit in the last place, at most 1 % of them
more than lr / 2 apart (see the test); the worst case measured is in
PERF.md."""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.synthetic import make_token_stream as ref_make_token_stream  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.transformer import init_transformer as ref_init_transformer  # noqa: E402
from repro.models.transformer import loss_fn as ref_loss_fn  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import chain as ref_chain  # noqa: E402
from repro.optim import clip_by_global_norm as ref_clip  # noqa: E402
from repro.optim import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import serving_params_from_jax  # noqa: E402
from repro_torch.data import make_token_stream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw, chain, clip_by_global_norm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["stablelm-3b", "hymba-1.5b", "xlstm-125m", "dbrx-132b", "deepseek-v3-671b"]
# xlstm with an mLSTM and an sLSTM layer, as xlstm-125m's "MMMS" has both:
# each layer leaves the other core's leaves without a gradient (zero, as
# the reference's where-selection gives them)
OVERRIDES = {"xlstm-125m": {"layer_pattern": "MS"}}
B, S = 2, 32


def _cfgs(name, **kw):
    kw = {**OVERRIDES.get(name, {}), **kw}
    return (dataclasses.replace(ref_get_config(name, reduced=True), **kw),
            dataclasses.replace(get_config(name, reduced=True), **kw))


@functools.cache
def _ref_init(name):
    """The reference's reduced fp32 parameters of ``name`` (numpy leaves),
    shared by the tests of one process."""
    ref_cfg, _ = _cfgs(name)
    return jax.tree.map(np.asarray, ref_init_transformer(jax.random.PRNGKey(0), ref_cfg))


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _ref_layer_leaves(ref_tree, cfg):
    """The reference's tree as the port's: layer leaves unstacked, as
    numpy float32, in the port's tree order."""
    return _leaves(serving_params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_tree),
        dataclasses.replace(cfg, dtype="float32")))


def _close_rel(got, want, tol, what):
    got, want = got.detach().to(torch.float32), want.to(torch.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got - want).abs().max())
    assert err <= tol * max(1.0, float(want.abs().max())), f"{what}: {err}"


def _batch(vocab, n=B, seed=3):
    data = ref_make_token_stream(n, S, vocab, seed=seed)
    return data.x, data.y


@pytest.mark.parametrize("name", MODELS)
def test_loss_fn_and_gradient_match_reference(name):
    ref_cfg, cfg = _cfgs(name)
    assert cfg.mtp == (name == "deepseek-v3-671b")
    ref_p = _ref_init(name)
    p = serving_params_from_jax(ref_p, cfg)
    x, y = _batch(cfg.vocab)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda pp, b: ref_loss_fn(pp, ref_cfg, b), has_aux=True))(
        ref_p, {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    leaves = [t.requires_grad_(True) for t in _leaves(p)]
    loss, metrics = tf.loss_fn(p, cfg, {"tokens": torch.from_numpy(x),
                                        "labels": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    assert set(metrics) == set(want_m)
    for k in want_m:
        assert abs(float(metrics[k]) - float(want_m[k])) <= 1e-5 * max(1.0, abs(float(want_m[k])))
    assert abs(float(loss) - float(want)) <= 1e-5 * float(want)
    ref_grads = _ref_layer_leaves(want_g, cfg)
    assert len(ref_grads) == len(grads)
    for i, (g, w) in enumerate(zip(grads, ref_grads)):
        _close_rel(g, w, 1e-4, f"grad leaf {i}")


def _ref_opt(lr, steps):
    return ref_chain(ref_clip(1.0), ref_adamw(ref_warmup_cosine(lr, 10, steps),
                                              weight_decay=0.01))


@pytest.mark.parametrize("name", ["stablelm-3b", "dbrx-132b"])
def test_three_launcher_steps_match_reference(name):
    ref_cfg, cfg = _cfgs(name)
    ref_p = jax.tree.map(jnp.asarray, _ref_init(name))
    p = serving_params_from_jax(_ref_init(name), cfg)
    ref_opt, opt = _ref_opt(3e-4, 3), train.make_optimizer(3e-4, 3)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    ref_step, step = ref_train.make_train_step(ref_cfg, ref_opt), train.make_train_step(cfg, opt)
    x, y = _batch(cfg.vocab, n=3 * B)
    for i in range(3):
        sl = slice(i * B, (i + 1) * B)
        ref_p, ref_s, want, _ = ref_step(ref_p, ref_s, {"tokens": jnp.asarray(x[sl]),
                                                        "labels": jnp.asarray(y[sl])})
        p, s, loss, metrics = step(p, s, {"tokens": torch.from_numpy(x[sl]),
                                          "labels": torch.from_numpy(y[sl])})
        assert abs(float(loss) - float(want)) <= 1e-5 * float(want), i
    for i, (a, w) in enumerate(zip(_leaves(p), _ref_layer_leaves(ref_p, cfg))):
        _close_rel(a, w, 1e-5, f"param leaf {i}")
    assert int(s[1]["count"]) == 3


def test_step_gives_unused_leaves_a_zero_gradient():
    """An xLSTM layer runs one of its two cores: the other core's leaves
    (the sLSTM layer's ``wq`` / ``wk``) move only by AdamW's weight decay,
    as a zero gradient moves them in the reference."""
    _, cfg = _cfgs("xlstm-125m")
    assert cfg.layer_pattern == "MS"
    p = tf.init_params(torch.Generator().manual_seed(0), cfg)
    opt = chain(clip_by_global_norm(1.0), adamw(1e-3, weight_decay=0.01))
    x, y = _batch(cfg.vocab)
    p2, state, loss, _ = train.make_train_step(cfg, opt)(
        p, opt.init(p), {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert torch.isfinite(loss)
    for name in ("wq", "wk"):
        assert not state[1]["m"]["layers"][1]["xlstm"][name].any()
        torch.testing.assert_close(p2["layers"][1]["xlstm"][name],
                                   p["layers"][1]["xlstm"][name] * (1 - 1e-3 * 0.01))
    assert state[1]["m"]["layers"][0]["xlstm"]["wq"].any()


def test_bf16_step_matches_reference():
    """One step at lr 1e-3 (no warmup) on reduced stablelm in bf16.  AdamW's
    first step moves each element by about lr one way or the other, so an
    element whose gradient lies within bf16 rounding of zero may move the
    other way in one package: each element within 2 lr plus one bf16 unit
    in the last place, and at most 1 % of them apart by more than lr / 2."""
    lr = 1e-3
    ref_cfg, cfg = _cfgs("stablelm-3b", dtype="bfloat16")
    ref_p = ref_init_transformer(jax.random.PRNGKey(0), ref_cfg)
    p = serving_params_from_jax(jax.tree.map(np.asarray, ref_p), cfg)
    ref_opt = ref_chain(ref_clip(1.0), ref_adamw(lr, weight_decay=0.01))
    opt = chain(clip_by_global_norm(1.0), adamw(lr, weight_decay=0.01))
    x, y = _batch(cfg.vocab)
    ref_p2, _, want, _ = ref_train.make_train_step(ref_cfg, ref_opt)(
        ref_p, ref_opt.init(ref_p), {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)})
    state = opt.init(p)
    assert any(t.dtype == torch.bfloat16 for t in _leaves(p))
    assert all(t.dtype == torch.float32 for t in _leaves(state[1]["m"]))
    p2, state, loss, _ = train.make_train_step(cfg, opt)(
        p, state, {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert abs(float(loss) - float(want)) <= 2e-3 * float(want)
    ref_leaves = _leaves(serving_params_from_jax(jax.tree.map(np.asarray, ref_p2), cfg))
    apart, total = 0, 0
    for i, (a, w) in enumerate(zip(_leaves(p2), ref_leaves)):
        assert a.dtype == w.dtype, i
        a, w = a.to(torch.float32), w.to(torch.float32)
        ulp = 2.0 ** (torch.floor(torch.log2(torch.clamp(w.abs(), min=1e-30))) - 7)
        diff = (a - w).abs()
        assert bool((diff <= 2 * lr + ulp).all()), (i, float(diff.max()))
        apart += int((diff > lr / 2).sum())
        total += diff.numel()
    assert apart <= 0.01 * total, apart / total


def _run_cli(*args, **env):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), **env},
                          capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_cli_trains_on_the_cpu_and_refuses_without_a_card(monkeypatch):
    r = _run_cli("--arch", "xlstm-125m", "--reduced", "--steps", "4", "--batch", "2",
                 "--seq", "64", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "step    0 loss" in r.stdout and "step    3 loss" in r.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available\\(\\) is False"):
        train.main(["--arch", "xlstm-125m", "--reduced", "--steps", "1"])


ARGS = ["--arch", "xlstm-125m", "--reduced", "--batch", "2", "--seq", "64", "--device", "cpu"]


@pytest.fixture
def one_thread():
    """One CPU thread: a multi-threaded CPU matrix product may split its sum
    differently from one run to the next (the tied head's gradient here),
    so that two runs of the same steps differ in their last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, capsys, one_thread):
    full = str(tmp_path / "full.ckpt")
    want_p, want_s = train.main([*ARGS, "--steps", "6", "--ckpt", full])
    # the first 3 of the same 6 steps (the 6-step run's data and schedule)
    cfg = get_config("xlstm-125m", reduced=True)
    params = tf.init_params(torch.Generator("cpu").manual_seed(0), cfg)
    opt = train.make_optimizer(3e-4, 6)
    state = opt.init(params)
    step = train.make_train_step(cfg, opt)
    data = make_token_stream(6 * 2, 64, cfg.vocab, seed=0)
    for i in range(3):
        batch = {"tokens": torch.from_numpy(data.x[2 * i:2 * i + 2]),
                 "labels": torch.from_numpy(data.y[2 * i:2 * i + 2])}
        params, state, _, _ = step(params, state, batch)
    part = str(tmp_path / "part.ckpt")
    save_checkpoint(part, (params, state), meta={"arch": cfg.name, "step": 3})
    got_p, got_s = train.main([*ARGS, "--steps", "6", "--resume", part])
    out = capsys.readouterr().out
    assert f"resumed {cfg.name} from {part} at step 3" in out and "step    5" in out
    assert "step    2" not in out.split("resumed")[1]
    for a, b in zip(_leaves((got_p, got_s)), _leaves((want_p, want_s))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    stored, meta = load_checkpoint(full, (want_p, want_s))
    assert meta == {"arch": cfg.name, "step": 6}
    assert all(torch.equal(a, b) for a, b in zip(_leaves(stored), _leaves((want_p, want_s))))


def test_resume_of_another_arch_exits_with_the_reference_message(tmp_path):
    ckpt = str(tmp_path / "x.ckpt")
    train.main([*ARGS, "--steps", "1", "--ckpt", ckpt])
    with pytest.raises(SystemExit, match="--resume checkpoint is for arch 'xlstm-125m-reduced', "
                                         "not 'stablelm-3b-reduced'"):
        train.main(["--arch", "stablelm-3b", "--reduced", "--steps", "2", "--batch", "2",
                    "--seq", "64", "--device", "cpu", "--resume", ckpt])


def test_non_token_configs_are_refused_with_the_reference_message(monkeypatch):
    frames = dataclasses.replace(get_config("xlstm-125m", reduced=True), input_mode="frames")
    monkeypatch.setattr(train, "get_config", lambda name, reduced=False: frames)
    with pytest.raises(SystemExit, match="is frames-input; use examples/serve_audio_vlm.py"):
        train.main([*ARGS, "--steps", "1"])
