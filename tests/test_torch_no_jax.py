"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the reference package ``repro``; entry
points default to the card and raise without one, the compiled and fused
engines too, and the async engines; the config accepts every registered
strategy, aggregator and client mode, validates the compiled backend's
options as the reference does, takes the systems and fault axes and the
async runtime and the population axis under the reference's rules and
error texts, and takes ``backend="scaleout"``, whose engine defaults to
the card too."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import make_classification, make_token_stream  # noqa: E402
from repro_torch.engine import FLConfig, make_engine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_file_list_is_complete():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").exists()
    assert "src/repro_torch/engine/host.py" in names
    for lm_module in ("configs/base.py", "configs/stablelm_3b.py", "models/common.py",
                      "models/attention.py", "models/transformer.py",
                      "kernels/flash_attention/ops.py", "kernels/flash_attention/ref.py",
                      "configs/hymba_1_5b.py", "models/ssm.py", "kernels/mamba_scan/__init__.py",
                      "kernels/mamba_scan/ops.py", "kernels/mamba_scan/ref.py",
                      "engine/client_modes.py", "engine/presets.py", "optim/fedmods.py",
                      "data/pipeline.py", "engine/compiled.py", "engine/fused.py",
                      "federated/compression.py", "systems/config.py",
                      "systems/profiles.py", "systems/clock.py", "systems/runtime.py",
                      "faults/config.py", "faults/health.py", "faults/models.py",
                      "faults/defense.py", "faults/runtime.py", "checkpoint/__init__.py",
                      "checkpoint/serializer.py", "checkpoint/policy.py",
                      "checkpoint/tracker.py", "engine/async_config.py",
                      "engine/async_engine.py", "population/__init__.py",
                      "population/config.py", "population/store.py",
                      "population/hierarchy.py", "configs/inputs.py", "serving/__init__.py",
                      "serving/scheduler.py", "launch/__init__.py", "launch/serve.py",
                      "launch/train.py", "optim/optimizers.py", "optim/schedules.py",
                      "models/moe.py", "configs/dbrx_132b.py", "configs/deepseek_v3_671b.py",
                      "configs/musicgen_large.py", "configs/internvl2_1b.py", "launch/mesh.py",
                      "federated/scaleout.py", "engine/scaleout.py", "sharding.py",
                      "launch/dryrun.py", "federated/simulation.py", "analysis/__init__.py",
                      "analysis/__main__.py", "analysis/lint.py", "analysis/contracts.py",
                      "analysis/rules/__init__.py", "analysis/rules/global_rng.py",
                      "analysis/rules/host_sync.py", "analysis/rules/capability_flags.py",
                      "analysis/rules/capture_stream.py"):
        assert f"src/repro_torch/{lm_module}" in names
    assert len(names) > 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train = make_classification(200, n_features=16, n_classes=4, seed=0)
    test = make_classification(50, n_features=16, n_classes=4, seed=1)
    cfg = FLConfig(n_clients=6, m=2, rounds=1, hidden=(8,), eval_samples=8, target_hd=0.5)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(cfg, train, test, 4)
    for kw in ({"backend": "compiled"}, {"backend": "compiled", "fuse_rounds": 2},
               {"backend": "compiled", "fuse_rounds": 2, "compress_bits": 8},
               {"systems": {"profile": "mobile_mix", "over_select": 1.5},
                "faults": {"rate": 0.2, "defense": "validate"}},
               {"systems": {"profile": "mobile_mix"}, "async_mode": {"buffer_k": 2}},
               {"backend": "compiled", "systems": {"profile": "mobile_mix"},
                "async_mode": {"buffer_k": 2}},
               {"backend": "scaleout"}):
        with pytest.raises(RuntimeError, match="cuda"):
            make_engine(FLConfig(**{**cfg.to_dict(), **kw}), train, test, 4)
    lm_cfg = FLConfig(task="lm", n_clients=4, m=2, rounds=1, batch_size=2, eval_samples=2,
                      target_hd=0.5, task_kwargs={"model": "stablelm-3b", "hist_bins": 8,
                                                  "overrides": {"vocab": 16}})
    tokens = make_token_stream(16, 8, 16, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(lm_cfg, tokens, tokens, 16)
    hymba_cfg = FLConfig(task="lm", n_clients=4, m=2, rounds=1, batch_size=2, eval_samples=2,
                         target_hd=0.5, task_kwargs={"model": "hymba-1.5b", "hist_bins": 8,
                                                     "overrides": {"vocab": 16}})
    with pytest.raises(RuntimeError, match="cuda"):
        make_engine(hymba_cfg, tokens, tokens, 16)
    from repro_torch.core.hellinger import hellinger_blocked

    with pytest.raises(RuntimeError, match="cuda"):
        hellinger_blocked([[1.0, 0.0], [0.5, 0.5]])


@pytest.mark.parametrize("field,value", [
    ("async_mode", {"dispatch": "sync"}),
    ("backend", "scaleout"),
    ("population", {"n_shards": 4, "shards_per_round": 2}),
    ("async_mode", {"buffer_k": 4, "concurrency": 8}),
    ("async_mode", {"buffer_k": 2}),
    ("population", {"n_shards": 8}),
    ("population", {"n_shards": 2}),
])
def test_config_rejects_unported_values(field, value):
    if field == "async_mode":
        # ported: these values lack the systems axis, which the reference's
        # own rule requires of the async runtime
        with pytest.raises(ValueError, match="async_mode needs the systems axis"):
            FLConfig(**{field: value})
        assert FLConfig(**{field: value, "systems": {}}).async_mode is not None
        return
    if field == "population":
        # ported: the dict form becomes a PopulationConfig and round-trips;
        # fused chunks still refuse it, as the reference's rule does
        from repro_torch.engine import PopulationConfig

        cfg = FLConfig(**{field: value})
        assert cfg.population == PopulationConfig(**value)
        assert FLConfig.from_dict(cfg.to_dict()) == cfg
        with pytest.raises(ValueError, match="population"):
            FLConfig(**{field: value, "backend": "compiled", "fuse_rounds": 2})
        return
    # ported: the scaleout backend builds, and refuses the population axis
    # as the reference does
    cfg = FLConfig(**{field: value})
    assert cfg.backend == value and FLConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="population"):
        FLConfig(**{field: value, "population": {"n_shards": 2}})


# Ported in the compiled backend's slice: alone, each builds (backend) or
# fails the reference's combination rule (fused chunks and compression
# need backend="compiled"), and on the compiled backend each builds.
@pytest.mark.parametrize("field,value,alone", [
    ("backend", "compiled", None),
    ("compress_bits", 4, "compress_bits > 0 quantizes cohort deltas"),
    ("fuse_rounds", 1, "fuse_rounds > 0 is a compiled-backend execution mode"),
    ("fuse_rounds", 4, "fuse_rounds > 0 is a compiled-backend execution mode"),
    ("compress_bits", 8, "compress_bits > 0 quantizes cohort deltas"),
])
def test_config_validates_compiled_backend_values(field, value, alone):
    if alone is None:
        assert getattr(FLConfig(**{field: value}), field) == value
    else:
        with pytest.raises(ValueError, match=alone):
            FLConfig(**{field: value})
    cfg = FLConfig(**{"backend": "compiled", field: value})
    assert getattr(cfg, field) == value and FLConfig.from_dict(cfg.to_dict()) == cfg


def test_config_takes_the_systems_and_fault_axes_under_the_reference_rules():
    from repro_torch.engine import FaultConfig, SystemsConfig

    cfg = FLConfig(systems={"profile": "mobile_mix", "deadline_s": 30.0, "over_select": 1.3},
                   faults={"rate": 0.2, "models": "sign_flip", "defense": "validate"})
    assert isinstance(cfg.systems, SystemsConfig) and isinstance(cfg.faults, FaultConfig)
    assert FLConfig.from_dict(cfg.to_dict()) == cfg
    assert FLConfig.from_dict(FLConfig().to_dict()).systems is None
    with pytest.raises(ValueError, match="systems must be"):
        FLConfig(systems=42)
    with pytest.raises(ValueError, match="faults must be"):
        FLConfig(faults="sign_flip")
    with pytest.raises(ValueError, match="unknown fault model"):
        FLConfig(faults={"models": ["nan"]})
    with pytest.raises(ValueError, match="stale_replay"):
        FLConfig(backend="compiled", fuse_rounds=2,
                 faults={"rate": 0.1, "models": ["stale_replay"]})
    with pytest.raises(ValueError, match="track_energy"):
        FLConfig(backend="compiled", fuse_rounds=2, systems={"track_energy": True})
    for kw in ({"backend": "compiled", "faults": {"models": ["stale_replay"]},
                "systems": {"track_energy": True}},
               {"backend": "compiled", "fuse_rounds": 2, "faults": {"models": ["sign_flip"]}}):
        assert FLConfig(**kw).faults is not None


@pytest.mark.parametrize("field,value", [
    ("strategy", "poc"),
    ("strategy_kwargs", {"cluster": "auto"}),
    ("aggregator", "fednova"),
    ("client_mode", "fedprox"),
])
def test_config_accepts_ported_values(field, value):
    cfg = FLConfig(**{field: value})
    assert getattr(cfg, field) == value and FLConfig.from_dict(cfg.to_dict()) == cfg


def test_config_rejects_bad_values_and_round_trips():
    with pytest.raises(ValueError):
        FLConfig(m=0)
    with pytest.raises(ValueError):
        FLConfig(strategy_kwargs={"nope": 1})
    with pytest.raises(ValueError):
        FLConfig(aggregator_kwargs={"trim_frac": 0.1})
    with pytest.raises(ValueError):
        FLConfig.from_dict({"bogus": 1})
    for field in ("strategy", "aggregator", "client_mode"):
        with pytest.raises(ValueError, match="unknown"):
            FLConfig(**{field: "no-such-name"})
    cfg = FLConfig(hidden=(32, 16), strategy_kwargs={"J": 2})
    assert FLConfig.from_dict(cfg.to_dict()) == cfg
