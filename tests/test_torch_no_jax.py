"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the reference package ``repro``; entry
points default to the card and raise without one; the config rejects
what this slice does not implement."""

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
                      "kernels/mamba_scan/ops.py", "kernels/mamba_scan/ref.py"):
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
    ("backend", "compiled"),
    ("task", "lm"),  # the LM task's default model, xlstm-125m, comes in a later slice
    ("strategy", "poc"),
    ("strategy_kwargs", {"cluster": "auto"}),
    ("aggregator", "fednova"),
    ("client_mode", "fedprox"),
    ("fuse_rounds", 4),
    ("compress_bits", 8),
    ("systems", {"profile": "mobile_mix"}),
    ("async_mode", {"buffer_k": 2}),
    ("faults", {"models": ["nan"]}),
    ("population", {"n_shards": 2}),
])
def test_config_rejects_unported_values(field, value):
    with pytest.raises(ValueError, match="repro_torch"):
        FLConfig(**{field: value})


def test_config_rejects_bad_values_and_round_trips():
    with pytest.raises(ValueError):
        FLConfig(m=0)
    with pytest.raises(ValueError):
        FLConfig(strategy_kwargs={"nope": 1})
    with pytest.raises(ValueError):
        FLConfig(aggregator_kwargs={"trim_frac": 0.1})
    with pytest.raises(ValueError):
        FLConfig.from_dict({"bogus": 1})
    cfg = FLConfig(hidden=(32, 16), strategy_kwargs={"J": 2})
    assert FLConfig.from_dict(cfg.to_dict()) == cfg
