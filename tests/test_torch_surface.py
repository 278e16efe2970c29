"""The reference's public names in the port: every module of ``repro_torch``
that has a counterpart in ``repro`` offers each name of that counterpart's
``__all__`` (or, without one, of its public functions and classes), under
the same module path, unless ``UNPORTED`` names it with the item that
brings it; and the functions new in this surface match the reference on
the same inputs (``quantize_delta`` / ``dequantize_delta`` exactly,
``weighted_delta`` within 1e-6)."""

import importlib
import importlib.util
import os
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.federated import aggregation as ref_aggregation  # noqa: E402
from repro.federated import compression as ref_compression  # noqa: E402
from repro.models.mlp import init_mlp as ref_init_mlp  # noqa: E402
from repro_torch.convert import leaf_segments, params_from_jax  # noqa: E402
from repro_torch.federated import compression  # noqa: E402
from repro_torch.models.mlp import MLPLayout  # noqa: E402

# Names of the reference that the port does not offer yet, by module, each
# with the ROADMAP item (or the reason) that keeps it out.
UNPORTED = {
    "repro.core.selection": {"fedlecc_select_jax": "a jax entry point; the port's is "
                                                   "fedlecc_select_mask"},
    "repro.kernels": {n: "the Pallas entry points; the port's kernels have their own"
                      for n in ("hellinger_matrix_pallas", "hellinger_strip_pallas",
                                "flash_attention_pallas", "masked_weighted_sum_pallas")},
    "repro.kernels.aggregate": {"masked_weighted_sum_pallas": "Pallas"},
    "repro.kernels.aggregate.ops": {"masked_weighted_sum_pallas": "Pallas",
                                    "aggregate_pytree_pallas": "Pallas"},
    "repro.kernels.flash_attention": {"flash_attention_pallas": "Pallas"},
    "repro.kernels.flash_attention.ops": {"flash_attention_pallas": "Pallas"},
    "repro.kernels.hellinger": {"hellinger_matrix_pallas": "Pallas",
                                "hellinger_strip_pallas": "Pallas"},
    "repro.kernels.hellinger.ops": {"hellinger_matrix_pallas": "Pallas",
                                    "hellinger_strip_pallas": "Pallas"},
    "repro.kernels.hellinger.ref": {"hellinger_matrix_ref": "the Pallas matrix path"},
    "repro.kernels.mamba_scan": {"mamba_scan_pallas": "Pallas"},
    "repro.kernels.mamba_scan.ops": {"mamba_scan_pallas": "Pallas"},
    "repro.launch.dryrun": {"collective_bytes": "it parses XLA's HLO text; the port's dry "
                                                "mesh tallies its collectives itself"},
    "repro.analysis.contracts": {"BANNED_CALLBACK_PRIMITIVES": "jaxpr primitives; the port "
                                                               "refuses BANNED_SYNC_OPS"},
}


# Modules of the reference without a port module, each with the item (or
# the reason) that keeps it out; every other module of these packages has one.
UNPORTED_MODULES = {
    "repro.jax_compat": "reference-only: a shim over moving JAX APIs",
    "repro.analysis.rules.prng": "no object in the port: its draws are counter hashes "
                                 "(engine/draws.py), not consumed keys, and no-global-rng "
                                 "covers torch's samplers",
    "repro.analysis.rules.jit_static": "its torch meaning is repro_torch.analysis.rules."
                                       "capture_stream (graph-capture-stream): every "
                                       "torch.cuda.graph names its stream",
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs():
    """(reference module, port module) for every port module whose
    counterpart exists in the reference."""
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                                      "repro_torch.")]
    for name in names:
        ref_name = "repro" + name[len("repro_torch"):]
        # repro.launch.dryrun sets XLA_FLAGS for its own process when imported;
        # keep it out of the environment that later subprocesses inherit
        flags = os.environ.get("XLA_FLAGS")
        try:
            ref = importlib.import_module(ref_name)
        except ModuleNotFoundError:
            continue
        finally:
            if flags is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = flags
        yield ref_name, ref, importlib.import_module(name)


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__]


def test_every_reference_name_with_a_port_counterpart_imports_from_the_same_path():
    missing, stale, seen = [], [], set()
    for ref_name, ref, port in _pairs():
        seen.add(ref_name)
        unported = UNPORTED.get(ref_name, {})
        for n in _public(ref):
            if n in unported:
                if hasattr(port, n):
                    stale.append(f"{ref_name}.{n}")
            elif not hasattr(port, n):
                missing.append(f"{ref_name}.{n}")
    assert not missing, f"reference names the port lacks: {missing}"
    assert not stale, f"ported names still listed as unported: {stale}"
    assert set(UNPORTED) <= seen
    assert {"repro.engine", "repro.core", "repro.models", "repro.optim",
            "repro.federated", "repro.systems", "repro.faults", "repro.checkpoint",
            "repro.engine.async_config", "repro.engine.async_engine",
            "repro.population", "repro.serving", "repro.serving.scheduler",
            "repro.launch.serve", "repro.configs.inputs", "repro.launch.train",
            "repro.optim.optimizers", "repro.optim.schedules", "repro.models.moe",
            "repro.launch.mesh", "repro.engine.scaleout", "repro.federated.scaleout",
            "repro.configs.musicgen_large", "repro.configs.internvl2_1b", "repro.sharding",
            "repro.analysis", "repro.analysis.lint", "repro.analysis.contracts",
            "repro.analysis.rules", "repro.analysis.rules.host_sync"} <= seen
    for package in ("systems", "faults", "checkpoint", "population", "serving", "launch",
                    "analysis"):
        ref = importlib.import_module(f"repro.{package}")
        modules = {m.name for m in pkgutil.walk_packages(ref.__path__, f"repro.{package}.")}
        missing = modules - seen - set(UNPORTED_MODULES)
        assert not missing, f"repro.{package} modules without a port: {missing}"
    assert not set(UNPORTED_MODULES) & seen, "ported modules still listed as unported"
    for name in UNPORTED_MODULES:
        assert importlib.util.find_spec(name) is not None, f"{name} is not in the reference"
    assert "repro.launch.dryrun" in seen and "repro.federated.simulation" in seen


def test_engine_exports_and_lists():
    from repro.engine import registry as ref_registry
    from repro_torch import engine

    for n in ("list_strategies", "list_aggregators", "list_client_modes", "list_tasks"):
        assert getattr(engine, n)() == getattr(ref_registry, n)(), n
    assert engine.registry.list_staleness_discounts() == ref_registry.list_staleness_discounts()
    assert type(engine.get_preset("fedavg")).__name__ == "ExperimentPreset"
    from repro_torch.core import get_strategy
    from repro_torch.core.strategies import UniformRandom
    from repro_torch.engine.client_modes import PlainMode, get_client_mode

    assert type(get_strategy("random", m=3)) is UniformRandom
    assert type(get_client_mode("plain")) is PlainMode


def _mlp_delta(seed):
    sizes = (12, 7, 5)
    ref = ref_init_mlp(jax.random.PRNGKey(seed), sizes)
    delta = jax.tree.map(lambda a: 0.3 * a, ref)
    return sizes, delta, params_from_jax(jax.tree.map(np.asarray, delta))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_and_dequantize_delta_match_reference(bits):
    sizes, delta, flat = _mlp_delta(bits)
    key = jax.random.PRNGKey(11)
    want = ref_compression.quantize_delta(delta, key, bits=bits)
    # the reference's uniforms: one jax.random.uniform a leaf, keys split a leaf
    leaves_ref, treedef = jax.tree.flatten(delta)
    keys = jax.random.split(key, len(leaves_ref))
    u = params_from_jax(jax.tree.unflatten(treedef, [
        np.asarray(jax.random.uniform(k, leaf.shape)) for leaf, k in zip(leaves_ref, keys)]))
    leaves = leaf_segments(MLPLayout(sizes))
    qt = compression.quantize_delta(flat, u, leaves, bits=bits)
    assert qt._fields == ref_compression.QuantizedTree._fields and qt.q.dtype == torch.int8
    np.testing.assert_array_equal(qt.q.numpy(), params_from_jax(want.q).numpy())
    # one scale a leaf, in the port's leaf order (each layer's w, then b)
    np.testing.assert_array_equal(qt.scale.numpy(), np.array(
        [layer[k] for layer in want.scale for k in ("w", "b")], np.float32))
    deq = compression.dequantize_delta(qt, leaves)
    np.testing.assert_array_equal(
        deq.numpy(), params_from_jax(ref_compression.dequantize_delta(want)).numpy())
    assert compression.bytes_per_param(bits) == \
        ref_compression.bytes_per_param(bits)


def test_weighted_delta_client_loss_and_he_init():
    from repro_torch.federated.aggregation import weighted_delta
    from repro_torch.federated.client import client_loss
    from repro_torch.models.common import he_init

    rng = np.random.default_rng(0)
    stacked = rng.normal(0, 1, (4, 33)).astype(np.float32)
    g = rng.normal(0, 1, 33).astype(np.float32)
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    want = ref_aggregation.weighted_delta(jnp.asarray(stacked), jnp.asarray(g), jnp.asarray(w))
    got = weighted_delta(torch.from_numpy(stacked), torch.from_numpy(g), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    loss = client_loss(lambda p, x: x * p, lambda out, y, mask: ((out - y) ** 2 * mask).sum(),
                       torch.tensor(2.0), torch.ones(3), torch.zeros(3), torch.tensor([1., 1., 0.]))
    assert float(loss) == 8.0
    w0 = he_init(torch.Generator().manual_seed(0), (400, 300))
    assert abs(w0.std().item() * np.sqrt(400 / 2) - 1.0) < 0.02
