"""The sharding policy, the logical-axis specs and the input specs against
the reference on the CPU; no device is allocated (a shape-only mesh, as the
reference's own ``tests/test_sharding.py`` uses, and ``meta`` tensors).

- ``transformer_specs``, ``cache_specs`` and the module specs
  (``gqa_specs``, ``mla_specs``, ``moe_specs``, ``mamba_specs``,
  ``xlstm_specs``) equal the reference's, tuple for tuple, for every
  config;
- ``make_policy``'s ``spec_for`` gives the entries of the reference's
  ``PartitionSpec`` for every leaf of every full config's spec tree (the
  reference's shapes from ``jax.eval_shape``) on both production mesh
  shapes, both variants, a full batch and batch 1 with the sequence
  sharded; the divisibility guard and the rule against reusing an axis
  hold on the reference's own examples;
- ``shardings`` over the port's ``init_params`` tree (a list of layers)
  gives each layer the stacked spec without its "layers" axis, which is
  the reference's spec of the stacked leaf, and refuses a tree of another
  structure;
- ``input_specs`` and ``decode_specs`` give the reference's shapes and
  types for every config and every one of ``INPUT_SHAPES``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro import sharding as ref_sharding  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import inputs as ref_inputs  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs import inputs  # noqa: E402
from repro_torch.models import attention, moe, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Shape-only stand-in: the policy reads ``shape`` and ``axis_names``."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, tuple, type(None))) for e in x)


@pytest.mark.parametrize("arch", list_configs())
def test_spec_trees_equal_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert tf.transformer_specs(cfg) == ref_tf.transformer_specs(ref_cfg)
    assert tf.cache_specs(cfg) == ref_tf.cache_specs(ref_cfg)
    assert attention.gqa_specs(cfg) == ref_attn.gqa_specs(ref_cfg)
    assert attention.mla_specs(cfg) == ref_attn.mla_specs(ref_cfg)
    assert ssm.mamba_specs(cfg) == ref_ssm.mamba_specs(ref_cfg)
    assert ssm.xlstm_specs(cfg) == ref_ssm.xlstm_specs(ref_cfg)
    if cfg.moe:
        assert moe.moe_specs(cfg) == ref_moe.moe_specs(ref_cfg)


@pytest.mark.parametrize("variant", ["baseline", "fsdp"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=["data-model", "pod-data-model"])
def test_policy_matches_reference_on_every_full_config(mesh_shape, variant):
    mesh = FakeMesh(mesh_shape)
    for arch in list_configs():
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        shapes = jax.tree.leaves(jax.eval_shape(
            lambda k, c=ref_cfg: ref_tf.init_transformer(k, c), jax.random.PRNGKey(0)))
        specs = jax.tree.leaves(tf.transformer_specs(cfg), is_leaf=_is_axes)
        assert len(specs) == len(shapes)
        for batch, shard_seq in ((256, False), (1, True)):
            ref_pol = ref_sharding.make_policy(mesh, batch, shard_seq=shard_seq,
                                               variant=variant)
            pol = sharding.make_policy(mesh, batch, shard_seq=shard_seq, variant=variant)
            assert pol.dp_axes == ref_pol.dp_axes and pol.rules == ref_pol.rules
            for sp, sh in zip(specs, shapes):
                assert pol.spec_for(sp, sh.shape) == tuple(ref_pol.spec_for(sp, sh.shape)), \
                    (arch, sp, sh.shape)
            for axes, shape in ((("batch", "seq_in"), (batch, 4096)),
                                (("layers", "batch", "seq", "kv_heads", None),
                                 (62, batch, 524288, 16, 128))):
                assert pol.spec_for(axes, shape) == tuple(ref_pol.spec_for(axes, shape))


def test_divisibility_guard_and_no_axis_reuse():
    """The reference's own examples."""
    pol = sharding.make_policy(FakeMesh({"data": 16, "model": 16}), batch_size=256)
    assert pol.spec_for(("vocab", "embed"), (32001, 1600)) == ()
    assert pol.spec_for(("vocab", "embed"), (151936, 5120)) == ("model",)
    pol = sharding.make_policy(FakeMesh({"pod": 2, "data": 16, "model": 16}), batch_size=256)
    assert pol.spec_for(("batch", "seq_in"), (256, 4096)) == (("pod", "data"),)
    pol = sharding.make_policy(FakeMesh({"data": 4, "model": 4}), batch_size=16)
    assert pol.spec_for(("experts", "ffn"), (16, 64)) == ("model",)
    pol = sharding.make_policy(FakeMesh({"data": 16, "model": 16}), batch_size=256,
                               variant="fsdp")
    assert pol.spec_for(("batch", "seq_in"), (256, 4096)) == (("data", "model"),)
    assert pol.spec_for(("embed", "ffn"), (5120, 17408)) == (None, ("data", "model"))
    assert pol.spec_for(("embed", "ffn"), (5120, 100)) == ()
    pol = sharding.make_policy(FakeMesh({"data": 16, "model": 16}), batch_size=1,
                               shard_seq=True, overrides={"kv_heads": None})
    assert pol.spec_for(("layers", "batch", "seq", "kv_heads", None),
                        (62, 1, 524288, 16, 128)) == (None, None, "data")


@pytest.mark.parametrize("arch", list_configs())
def test_shardings_line_up_with_the_port_tree(arch):
    """The reduced config's ``init_params`` tree: each layer's leaf takes
    the stacked spec without the "layers" axis, the reference's spec of the
    stacked leaf (whose "layers" entry is never sharded)."""
    ref_cfg, cfg = ref_get_config(arch, reduced=True), get_config(arch, reduced=True)
    mesh = FakeMesh({"data": 2, "model": 4})
    pol = sharding.make_policy(mesh, 8)
    ref_pol = ref_sharding.make_policy(mesh, 8)
    tree = tf.init_params(torch.Generator().manual_seed(0), cfg)
    got = pol.shardings(tf.transformer_specs(cfg), tree)
    assert len(got["layers"]) == cfg.n_layers
    ref_shapes = jax.eval_shape(lambda k: ref_tf.init_transformer(k, ref_cfg),
                                jax.random.PRNGKey(0))
    want = jax.tree.map(lambda sp, sh: tuple(ref_pol.spec_for(sp, sh.shape)),
                        ref_tf.transformer_specs(ref_cfg), ref_shapes, is_leaf=_is_axes)
    for layer in got["layers"]:
        flat = jax.tree.leaves(layer, is_leaf=_is_axes)
        ref_flat = jax.tree.leaves(want["layers"], is_leaf=_is_axes)
        assert [s[1:] if s else s for s in ref_flat] == flat
    assert {k: v for k, v in got.items() if k != "layers"} == \
        {k: v for k, v in want.items() if k != "layers"}
    wrong = dict(tree, extra=torch.zeros(1))
    with pytest.raises(ValueError, match="specs/shapes mismatch"):
        pol.shardings(tf.transformer_specs(cfg), wrong)
    got = jax.tree.leaves(pol.shardings(tf.cache_specs(cfg), tf.init_cache(cfg, 2, 8)),
                          is_leaf=_is_axes)
    shapes = jax.tree.leaves(jax.eval_shape(lambda: ref_tf.init_cache(ref_cfg, 2, 8)))
    want = jax.tree.leaves(ref_tf.cache_specs(ref_cfg), is_leaf=_is_axes)
    assert got == [tuple(ref_pol.spec_for(sp, sh.shape)) for sp, sh in zip(want, shapes)]


@pytest.mark.parametrize("arch", list_configs())
def test_input_and_decode_specs_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    for name in INPUT_SHAPES:
        for ref_fn, fn in ((ref_inputs.input_specs, inputs.input_specs),
                           (ref_inputs.decode_specs, inputs.decode_specs)):
            want, got = ref_fn(ref_cfg, name), fn(cfg, INPUT_SHAPES[name])
            assert list(got) == list(want), (arch, name)
            for k in want:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == want[k].shape, (arch, name, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(np.dtype(want[k].dtype))
            assert {k: v.shape for k, v in fn(cfg, name).items()} == \
                {k: v.shape for k, v in got.items()}          # a shape's name will do
