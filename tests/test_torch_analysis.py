"""``repro_torch.analysis`` (the port's tracecheck) against the reference's
``repro.analysis`` on the same inputs.

The lint rules that both packages have give the same (rule, line, col) on
the reference's own corpus (``tests/test_analysis.py``'s snippets;
``capability-flags`` with the port's method name ``select_mask``); the
torch rules each get a violating and a clean snippet; the port's tree is
lint-clean; the lint layer imports no torch.  ``run_contracts("cpu")``
(through the CLI's ``--json`` report) passes every mask contract on
``TASK_SHAPES``, skips the card-only ones with their reason, and the
contracts' masks equal the reference's ``select_mask_jax`` /
``select_mask_traced`` on the same losses.  The CLI's JSON carries the
reference's keys and exits non-zero on a violating ``--root``."""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import contracts as ref_contracts  # noqa: E402
from repro.analysis import lint_source as ref_lint_source  # noqa: E402
from repro.analysis.__main__ import main as ref_main  # noqa: E402
from repro_torch.analysis import contracts, lint_source, run_lint  # noqa: E402
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.rules import RULES, rule_catalog  # noqa: E402
from repro_torch.engine.registry import (  # noqa: E402
    mask_selection_strategies,
    traced_selection_strategies,
)
from test_torch_engine import jax_selection_noise  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ANALYSIS = ROOT / "src" / "repro_torch" / "analysis"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lint(src, **kw):
    return lint_source(textwrap.dedent(src), **kw)


def positions(violations):
    return [(v.rule, v.line, v.col) for v in violations]


# ---------------------------------------------------------------- catalog
def test_rule_catalog():
    names = {name for name, _ in rule_catalog()}
    assert names == {"no-global-rng", "no-host-sync", "capability-flags",
                     "graph-capture-stream"}
    assert all(desc for _, desc in rule_catalog())
    assert set(RULES) == names


# ------------------------------------------- the reference's corpus, both lints
# (rule, snippet, findings): the snippets of tests/test_analysis.py for the
# rules the port shares; capability-flags' use the reference's method name,
# which the port's copy renames to select_mask
SHARED_CORPUS = {
    "global-rng-violating": ("no-global-rng", """
        import numpy as np
        import random

        def f():
            a = np.random.normal(size=3)
            np.random.seed(0)
            b = random.random()
            random.seed(1)
            return a, b
    """, 4),
    "global-rng-clean": ("no-global-rng", """
        import numpy as np

        def f(seed):
            rng = np.random.default_rng(seed)
            return rng.normal(size=3)
    """, 0),
    "global-rng-alias": ("no-global-rng", """
        import numpy.random as npr

        def f():
            return npr.uniform()
    """, 1),
    "global-rng-local-random-module": ("no-global-rng", """
        from mypkg import random

        def f():
            return random.shuffle_thing()
    """, 0),
    "capability-missing-method": ("capability-flags", """
        class Base:
            supports_compiled_selection = False

        class S(Base):
            supports_compiled_selection = True
    """, 1),
    "capability-contradiction": ("capability-flags", """
        class S:
            supports_traced_selection = False

            def select_mask_traced(self, losses, key):
                return losses > 0
    """, 1),
    "capability-method-without-flag": ("capability-flags", """
        class S:
            def select_mask_jax(self, losses, rng=None):
                return losses > 0
    """, 1),
    "capability-local-inheritance": ("capability-flags", """
        class Base:
            supports_compiled_selection = False
            supports_traced_selection = False

        class Full(Base):
            supports_compiled_selection = True
            supports_traced_selection = True

            def select_mask_jax(self, losses, rng=None):
                return losses > 0

            def select_mask_traced(self, losses, key):
                return losses > 0

        class OptOut(Full):
            supports_traced_selection = False
    """, 0),
    "capability-unknown-base": ("capability-flags", """
        from elsewhere import MaskBase

        class S(MaskBase):
            supports_compiled_selection = True
    """, 0),
    "pragma-line": ("no-global-rng", """
        import numpy as np

        x = np.random.normal()  # tracecheck: disable=no-global-rng
        y = np.random.normal()
    """, 1),
    "pragma-file": ("no-global-rng", """
        # tracecheck: disable-file=no-global-rng
        import numpy as np

        x = np.random.normal()
        y = np.random.normal()
    """, 0),
}


@pytest.mark.parametrize("case", sorted(SHARED_CORPUS))
def test_shared_rules_give_the_reference_findings(case):
    rule, src, n = SHARED_CORPUS[case]
    src = textwrap.dedent(src)
    want = positions(ref_lint_source(src, rules=[rule]))
    got = positions(lint_source(src.replace("select_mask_jax", "select_mask"), rules=[rule]))
    assert got == want
    assert len(got) == n


# ---------------------------------------------------------------- torch snippets
# (rule, snippet, findings, lint_source keywords)
TORCH_CORPUS = {
    "global-rng-torch-violating": ("no-global-rng", """
        import torch
        from torch import nn

        def f(w):
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
            a = torch.rand(3)
            b = torch.randperm(5, device="cuda")
            w.normal_()
            nn.init.uniform_(w)
            return a, b, torch.multinomial(a, 1), torch.bernoulli(a)
    """, 8, {}),
    "global-rng-torch-clean": ("no-global-rng", """
        import torch

        def f(w, seed):
            g = torch.Generator().manual_seed(seed)
            w.normal_(generator=g)
            return torch.rand(3, generator=g), torch.randperm(5, generator=g)
    """, 0, {}),
    "host-sync-in-capture-block": ("no-host-sync", """
        import torch

        class Eng:
            def capture(self, g, side, x):
                with torch.cuda.graph(g, stream=side):
                    y = x * 2
                    n = y.sum().item()
                return n
    """, 1, {"hot_path": True}),
    "host-sync-two-hop-self-chain": ("no-host-sync", """
        import torch

        class Eng:
            def capture(self, g, side, x):
                with torch.cuda.graph(g, stream=side):
                    out = self._body(x)
                return out

            def _body(self, x):
                return self._step(x) + 1

            def _step(self, x):
                return x.cpu()
    """, 1, {"hot_path": True}),
    "host-sync-traced-selection": ("no-host-sync", """
        import torch

        class S:
            def select_mask_traced(self, losses, noise):
                keep = torch.nonzero(losses > 0)
                return self._rank(losses, keep)

            def _rank(self, losses, keep):
                return losses.unique()
    """, 2, {"hot_path": True}),
    "host-sync-cross-file-entry": ("no-host-sync", """
        import numpy as np

        class CompiledEngine:
            def _device_round(self, params):
                return self._tail(params)

            def _tail(self, params):
                return float(params.sum())

            def _device_step(self, mask):
                return np.flatnonzero(mask.cpu().numpy())
    """, 1, {"hot_path": True, "captured": ("CompiledEngine._device_round",)}),
    "host-sync-cold-path-clean": ("no-host-sync", """
        import numpy as np
        import torch

        class Eng:
            def capture(self, g, side, x):
                with torch.cuda.graph(g, stream=side):
                    out = self._body(x)
                return out, self._read(out)

            def _body(self, x):
                return x * 2

            def _read(self, out):
                return float(out.sum()), np.asarray(out.cpu()), out.item()

        def host_helper(x):
            return x.tolist()
    """, 0, {"hot_path": True}),
    "host-sync-not-hot-path": ("no-host-sync", """
        import torch

        def capture(g, side, x):
            with torch.cuda.graph(g, stream=side):
                return x.sum().item()
    """, 0, {"hot_path": False}),
    "capture-stream-violating": ("graph-capture-stream", """
        import torch
        from torch.cuda import graph

        def f(g, pool):
            with torch.cuda.graph(g):
                pass
            with graph(g, pool):
                pass
    """, 2, {}),
    "capture-stream-clean": ("graph-capture-stream", """
        import torch

        def f(g, pool, side):
            with torch.cuda.graph(g, stream=side):
                pass
            with torch.cuda.graph(g, pool, side):
                pass
    """, 0, {}),
}


@pytest.mark.parametrize("case", sorted(TORCH_CORPUS))
def test_torch_rules(case):
    rule, src, n, kw = TORCH_CORPUS[case]
    found = lint(src, rules=[rule], **kw)
    assert len(found) == n, [str(v) for v in found]
    assert {v.rule for v in found} <= {rule}


# ---------------------------------------------------------------- the tree
def test_port_library_code_is_lint_clean():
    report = run_lint()
    assert report.files_checked > 50
    assert report.ok, "\n".join(str(v) for v in report.violations)


def test_the_lint_layer_imports_no_torch():
    files = [ANALYSIS / "__init__.py", ANALYSIS / "lint.py", *sorted((ANALYSIS / "rules").glob("*.py"))]
    for path in files:
        roots = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
        assert not roots & {"torch", "numpy", "jax", "repro"}, (path, roots)


# ---------------------------------------------------------------- contracts
@pytest.fixture(scope="module")
def cli_report():
    """``python -m repro_torch.analysis --device cpu --json``, in process:
    (exit code, payload)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--device", "cpu", "--json"])
    return rc, json.loads(buf.getvalue())


def test_cli_on_the_cpu_passes_with_the_reference_keys(cli_report):
    rc, payload = cli_report
    assert rc == 0 and payload["ok"] is True
    assert payload["lint"]["violations"] == []
    assert set(payload) == {"lint", "contracts", "ok"}  # the reference CLI's full report
    assert set(ref_contracts.ContractReport().to_dict()) <= set(payload["contracts"])
    ref_result = set(ref_contracts.ContractResult("x", True).to_dict())
    assert all(set(r) == ref_result for r in payload["contracts"]["results"])


def test_mask_contracts_cover_every_strategy_and_task(cli_report):
    _, payload = cli_report
    results = {r["name"]: r for r in payload["contracts"]["results"]}
    assert contracts.TASK_SHAPES == ref_contracts.TASK_SHAPES
    for task in contracts.TASK_SHAPES:
        for name in mask_selection_strategies():
            r = results[f"mask/{task}/{name}/compiled"]
            assert r["ok"] and not r["skipped"], r
        for name in traced_selection_strategies():
            r = results[f"mask/{task}/{name}/traced"]
            assert r["ok"] and not r["skipped"] and "no synchronizing op" in r["detail"], r
    for (name, tier), op in contracts.META_UNSUPPORTED.items():
        for task in contracts.TASK_SHAPES:
            assert op in results[f"mask/{task}/{name}/{tier}"]["detail"]


def test_card_only_contracts_skip_with_a_reason_and_scaleout_runs(cli_report):
    _, payload = cli_report
    results = {r["name"]: r for r in payload["contracts"]["results"]}
    card_only = {"donation/fused-chunk-carry", "retrace/library-loads",
                 "retrace/compiled-syncs", "retrace/fused-captures", "retrace/fused-syncs"}
    for name in card_only:
        assert results[name]["skipped"] and results[name]["detail"].startswith("card only: ")
    assert results["retrace/scaleout"]["ok"] and not results["retrace/scaleout"]["skipped"]
    assert {r["name"] for r in payload["contracts"]["results"] if r["skipped"]} == card_only
    # on the card a skip fails the report
    report = contracts.ContractReport(device="cuda", results=[
        contracts.ContractResult("x", True, "card only", skipped=True)])
    assert not report.ok


MASK_CASES = [(task, name, tier) for task in contracts.TASK_SHAPES
              for name in mask_selection_strategies() for tier in ("compiled", "traced")
              if tier == "compiled" or name in traced_selection_strategies()]


@pytest.mark.parametrize("task,name,tier", MASK_CASES)
def test_contract_masks_equal_the_reference(task, name, tier):
    K, m, C = contracts.TASK_SHAPES[task]
    port = contracts._strategy(name, K, m, C, "cpu")
    ref = ref_contracts._strategy(name, K, m, C)
    losses = contracts._losses(K, "cpu")
    if tier == "compiled":
        got = port.select_mask(losses, np.random.default_rng(0))
        want = ref.select_mask_jax(jnp.asarray(losses.numpy()), np.random.default_rng(0))
    else:
        key = jax.random.PRNGKey(0)
        noise = jax_selection_noise(key, port.traced_noise, K, getattr(port, "n_clusters", 0))
        got = port.select_mask_traced(losses, noise)
        want = ref.select_mask_traced(jnp.asarray(losses.numpy()), key)
        if port.traced_noise is None:  # the contract's own call draws no noise
            assert torch.equal(port.select_mask_traced(losses, contracts._noise(port, K, "cpu")),
                               got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == m


@pytest.mark.parametrize("op", ["item", "nonzero", "unique", "masked_select", "bool_index",
                                "bool"])
def test_refuse_syncs_refuses_each_banned_op(op):
    x = torch.arange(4.0)
    calls = {"item": lambda: x.sum().item(), "nonzero": lambda: torch.nonzero(x),
             "unique": lambda: torch.unique(x),
             "masked_select": lambda: torch.masked_select(x, x > 1),
             "bool_index": lambda: x[x > 1], "bool": lambda: bool(x.sum() > 0)}
    with pytest.raises(AssertionError, match="synchronizing op"):
        with contracts._RefuseSyncs(torch.device("cpu")):
            calls[op]()
    with contracts._RefuseSyncs(torch.device("cpu")):
        torch.sort(x, stable=True).indices.scatter_(0, torch.tensor([0]), 1)  # no sync


def test_budgets_and_the_card_only_drive():
    assert contracts.RETRACE_BUDGET == ref_contracts.RETRACE_BUDGET == 1
    assert contracts.FUSED_CHUNK_BUDGET == ref_contracts.FUSED_CHUNK_BUDGET
    # on the CPU drive_twice drives both calls and counts nothing
    eng = contracts._tiny_engine("cpu", backend="compiled", fuse_rounds=2)
    out = contracts.drive_twice(eng, 4, 2)
    assert list(out) == ["selected"] and len(out["selected"]) == 6 and eng._round == 6


# ---------------------------------------------------------------- CLI
def test_cli_exits_nonzero_on_violation_with_the_reference_keys(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(
        "import numpy as np\nimport torch\nx = np.random.normal()\ny = torch.rand(2)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--lint-only", "--json",
         "--root", str(tmp_path)],
        capture_output=True, text=True, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] is False
    assert [(v["rule"], v["line"]) for v in payload["lint"]["violations"]] == [
        ("no-global-rng", 3), ("no-global-rng", 4)]
    assert ref_main(["--lint-only", "--json", "--root", str(tmp_path)]) == 1
    ref_payload = json.loads(capsys.readouterr().out)
    assert set(payload) == set(ref_payload)
    assert set(payload["lint"]) == set(ref_payload["lint"])
    assert set(payload["lint"]["violations"][0]) == set(ref_payload["lint"]["violations"][0])


def test_cli_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--contracts-only"])
    assert main(["--list"]) == 0
