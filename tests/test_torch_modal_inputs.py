"""Frame and image-patch inputs (musicgen-large, internvl2-1b) against the
JAX package on the CPU, at the reduced configs (2 layers, d_model 256;
internvl2's 8 patches), from the reference's own weights
(``serving_params_from_jax``, which carries musicgen's ``frame_norm``).

- the two configs and ``INPUT_SHAPES`` equal the reference's;
- ``dummy_batch`` / ``dummy_decode_batch``: the same arrays bit for bit,
  fp32 (reduced) and bf16 (full width, a few positions);
- ``embed_inputs`` and its loss mask, and ``loss_fn``, within 1e-5
  relative in fp32;
- ``prefill``'s logits and cache and three ``decode_step``s within 1e-4
  (logits) and 1e-5 (cache), relative to max(1, max |reference|);
- ``launch.serve.main`` on the CPU for both models;
- the FL task and ``launch/train.py`` still refuse both input modes with
  the reference's messages, and the flat layout refuses them."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import INPUT_SHAPES as REF_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import inputs as ref_inputs  # noqa: E402
from repro.engine import FLConfig as RefFLConfig  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config, list_configs  # noqa: E402
from repro_torch.configs import inputs  # noqa: E402
from repro_torch.convert import cache_to_numpy, serving_params_from_jax  # noqa: E402
from repro_torch.engine import FLConfig  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

MODELS = ("musicgen-large", "internvl2-1b")
S = 12           # prompt positions (internvl2: 8 patches and 4 tokens)
B = 2



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch calls from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} x {scale}"


def _to_jax(batch):
    return {k: jnp.asarray(v.float().numpy() if v.is_floating_point() else v.numpy())
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, reference config, port config, reference params, port params)
    at the reduced width; musicgen's frame_norm drawn away from zero so
    that it enters every number."""
    name = request.param
    ref_cfg, cfg = ref_get_config(name, reduced=True), get_config(name, reduced=True)
    ref_p = ref_tf.init_transformer(jax.random.PRNGKey(0), ref_cfg)
    if "frame_norm" in ref_p:
        ref_p = {**ref_p, "frame_norm": 0.3 * jax.random.normal(jax.random.PRNGKey(1),
                                                                 ref_p["frame_norm"].shape)}
    return name, ref_cfg, cfg, ref_p, serving_params_from_jax(jax.tree.map(np.asarray, ref_p),
                                                              cfg)


@pytest.mark.parametrize("name", MODELS)
def test_configs_and_input_shapes_equal_the_reference(name):
    for reduced in (False, True):
        assert dataclasses.asdict(get_config(name, reduced=reduced)) == dataclasses.asdict(
            ref_get_config(name, reduced=reduced))
    assert len(list_configs()) == 10
    assert {k: tuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: tuple(v) for k, v in REF_INPUT_SHAPES.items()}
    assert INPUT_SHAPES["train_4k"] == InputShape("train_4k", 4096, 256, "train")


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_dummy_batches_draw_the_reference_bits(name, reduced):
    ref_cfg, cfg = ref_get_config(name, reduced=reduced), get_config(name, reduced=reduced)
    seq = S if reduced else ref_cfg.n_patches + 3   # full width: a few positions past the patches
    want, got = ref_inputs.dummy_batch(ref_cfg, B, seq, seed=3), inputs.dummy_batch(cfg, B, seq,
                                                                                    seed=3)
    assert list(got) == list(want)
    dec_want, dec_got = (ref_inputs.dummy_decode_batch(ref_cfg, B, seed=4),
                         inputs.dummy_decode_batch(cfg, B, seed=4))
    assert list(dec_got) == list(dec_want)
    for k, w in [*want.items(), *dec_want.items()]:
        g = got[k] if k in got else dec_got[k]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        if g.dtype == torch.bfloat16:   # bit for bit: compare the raw 16-bit words
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)


def test_embed_inputs_and_loss_match_the_reference(model):
    name, ref_cfg, cfg, ref_p, p = model
    batch = inputs.dummy_batch(cfg, B, S, seed=5)
    x_want, m_want = ref_tf.embed_inputs(ref_p, ref_cfg, _to_jax(batch))
    x, m = tf.embed_inputs(p, cfg, batch)
    _close(x, x_want, 1e-5, "embedded inputs")
    if name == "internvl2-1b":
        assert m.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_want))
        assert float(m[:, :cfg.n_patches].sum()) == 0 and float(m[:, cfg.n_patches:].min()) == 1
    else:
        assert m is None and m_want is None
    (want, want_metrics) = ref_tf.loss_fn(ref_p, ref_cfg, _to_jax(batch))
    loss, metrics = tf.loss_fn(p, cfg, batch)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(metrics["ce"]) - float(want_metrics["ce"])) <= 1e-5 * abs(float(want))


def test_prefill_and_three_decode_steps_match_the_reference(model):
    name, ref_cfg, cfg, ref_p, p = model
    batch = inputs.dummy_batch(cfg, B, S, seed=6)
    batch.pop("labels")
    max_len = S + 4
    want, ref_cache = ref_tf.prefill(ref_p, ref_cfg, _to_jax(batch), max_len)
    got, cache = tf.prefill(p, cfg, batch, max_len)
    _close(got, want, 1e-4, "prefill logits")
    ref_step = jax.jit(lambda pp, b, c, pos: ref_tf.decode_step(pp, ref_cfg, b, c, pos))
    for j, pos in enumerate(range(S, S + 3)):
        step = inputs.dummy_decode_batch(cfg, B, seed=10 + j)
        want, ref_cache = ref_step(ref_p, _to_jax(step), ref_cache, jnp.int32(pos))
        got, cache = tf.decode_step(p, cfg, step, cache, pos)
        _close(got, want, 1e-4, f"decode logits {pos}")
        got_cache = cache_to_numpy(cache)
        for k in ("k", "v"):
            _close(got_cache[k], ref_cache[k], 1e-5, f"decode {pos} cache {k}")
        np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_serving_params_carry_frame_norm(model):
    name, ref_cfg, cfg, ref_p, p = model
    if name != "musicgen-large":
        assert "frame_norm" not in p and "frame_norm" not in ref_p
        return
    assert p["frame_norm"].dtype == torch.float32 and float(p["frame_norm"].abs().max()) > 0
    np.testing.assert_array_equal(p["frame_norm"].numpy(), np.asarray(ref_p["frame_norm"]))
    # a bf16 model keeps frame_norm in fp32, zero at init, as the reference's
    bf16 = tf.init_params(torch.Generator().manual_seed(0), dataclasses.replace(cfg,
                                                                                dtype="bfloat16"))
    assert bf16["frame_norm"].dtype == torch.float32 and bf16["embed"].dtype == torch.bfloat16
    assert torch.equal(bf16["frame_norm"], torch.zeros(cfg.d_model))


def test_prefill_then_decode_matches_forward_for_frames():
    cfg = get_config("musicgen-large", reduced=True)
    p = tf.init_params(torch.Generator().manual_seed(1), cfg)
    frames = inputs.dummy_batch(cfg, B, S, seed=2)["frames"]
    want = tf._logits(p, cfg, tf.forward(p, cfg, tf.embed_inputs(p, cfg, {"frames": frames})[0])
                      [:, -1])
    _, cache = tf.prefill(p, cfg, {"frames": frames[:, :-1]}, S + 4)
    got, _ = tf.decode_step(p, cfg, {"frame": frames[:, -1:]}, cache, S - 1)
    _close(got, want, 1e-4, "decode vs forward")


@pytest.mark.parametrize("name", MODELS)
def test_serve_main_on_the_cpu(name, capsys):
    from repro_torch.launch import serve

    gen = serve.main(["--arch", name, "--reduced", "--batch", "2", "--prompt-len", "12",
                      "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2×12" in out and "decoded 4 tokens × 2 seqs" in out
    assert gen.shape == (2, 4) and int(gen.min()) >= 0 and int(gen.max()) < 512
    if name == "internvl2-1b":
        with pytest.raises(ValueError, match="8 image patches"):
            serve.main(["--arch", name, "--reduced", "--prompt-len", "8", "--device", "cpu"])


def _raises_same(ref_call, port_call, exc=ValueError):
    with pytest.raises(exc) as ref_err:
        ref_call()
    with pytest.raises(exc) as err:
        port_call()
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("name", MODELS)
def test_federated_training_and_the_launcher_refuse_both_modes(name, monkeypatch):
    kw = dict(task="lm", task_kwargs={"model": name}, n_clients=4, m=2)
    _raises_same(lambda: RefFLConfig(**kw), lambda: FLConfig(**kw))
    with pytest.raises(ValueError, match="flat transformer layout .* token inputs"):
        tf.TransformerLayout(get_config(name, reduced=True))
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=f"{name} is .*-input; use examples/serve_audio_vlm.py"):
        train.main(["--arch", name, "--reduced", "--device", "cpu"])
    from repro_torch.serving import BatchScheduler

    cfg = get_config(name, reduced=True)
    with pytest.raises(ValueError, match="input"):
        BatchScheduler(cfg, tf.init_params(torch.Generator().manual_seed(0), cfg))
