"""The AST lint for the tracecheck rules, ported from
``repro.analysis.lint``.

Stdlib-only by design: linting the tree must never import the modules
it checks (and must work where torch is not installed).  Rules live in
``repro_torch.analysis.rules`` and receive a parsed ``ast.Module`` plus
a ``FileContext``; this module owns file discovery, pragma suppression,
and report assembly.

Suppression pragmas (comments, matched per physical line):

- ``# tracecheck: disable=<rule>[,<rule>...]`` — suppress the named
  rules on that line (attach to the offending line).
- ``# tracecheck: disable`` — suppress every rule on that line.
- ``# tracecheck: disable-file[=<rules>]`` — on a line of its own,
  suppress the named rules (or all) for the whole file.
"""

from __future__ import annotations

import ast
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Iterable, Sequence

__all__ = [
    "CAPTURED_ENTRY_POINTS",
    "FileContext",
    "HOT_PATH_MODULES",
    "LintReport",
    "Violation",
    "default_root",
    "lint_paths",
    "lint_source",
    "run_lint",
]

# Modules whose device code runs inside captured CUDA graphs (the fused
# chunk) or on every round of the compiled and scaleout backends: a host
# sync there is a round-time performance bug, and inside a capture an
# error (paths relative to the ``repro_torch`` package root; a trailing
# ``/`` marks a package prefix).
HOT_PATH_MODULES: tuple[str, ...] = (
    "engine/compiled.py",
    "engine/fused.py",
    "engine/scaleout.py",
    "core/selection.py",
    "core/strategies.py",
    "kernels/",
)

# Functions that run under a CUDA-graph capture although nothing in their
# own file captures them: the call chain crosses files.  The fused chunk
# body (``engine/fused.py``, inside ``torch.cuda.graph``) calls the
# compiled round (``CompiledEngine._device_round``), which polls through
# the base engine and gathers and weighs the cohort with the selection
# core; ``select_mask_traced`` reaches the same core.  The ``no-host-sync``
# rule takes each entry as a captured root in its file (a method as
# ``Class.method``) and follows its ``self.`` and same-file calls.
CAPTURED_ENTRY_POINTS: dict[str, tuple[str, ...]] = {
    "engine/compiled.py": ("CompiledEngine._device_round",),
    "engine/base.py": ("Engine._poll",),
    "core/selection.py": ("fedlecc_select_mask", "top_m_mask", "cohort_indices",
                          "selection_weights"),
}

_PRAGMA = re.compile(
    r"#\s*tracecheck:\s*disable(?P<scope>-file)?(?:=(?P<rules>[\w.,\- ]+))?"
)


@dataclass(frozen=True)
class Violation:
    """One lint finding: ``rule`` at ``path:line:col`` with a message."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class FileContext:
    """Per-file information handed to every rule."""

    path: str                  # display path (repo-relative when possible)
    rel_module: str            # posix path relative to the package root
    source: str
    is_hot_path: bool
    captured: tuple[str, ...] = ()  # this file's CAPTURED_ENTRY_POINTS


@dataclass
class LintReport:
    """All violations of one lint run plus the files covered."""

    violations: list[Violation] = field(default_factory=list)
    files_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "files_checked": self.files_checked,
            "violations": [v.to_dict() for v in self.violations],
        }


def default_root() -> Path:
    """The ``repro_torch`` package directory — the library-code lint scope."""
    return Path(__file__).resolve().parent.parent


def _is_hot_path(rel_module: str) -> bool:
    for pat in HOT_PATH_MODULES:
        if pat.endswith("/"):
            if rel_module.startswith(pat):
                return True
        elif rel_module == pat:
            return True
    return False


def _pragma_suppressions(source: str) -> tuple[dict[int, set[str] | None], set[str] | None]:
    """Line → suppressed rule names (``None`` = all rules), plus the
    file-level suppression set (``None`` = all, empty set = none)."""
    per_line: dict[int, set[str] | None] = {}
    file_level: set[str] | None = set()
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(text)
        if not m:
            continue
        rules_txt = m.group("rules")
        rules = (
            None if rules_txt is None
            else {r.strip() for r in rules_txt.split(",") if r.strip()}
        )
        if m.group("scope"):
            if rules is None or file_level is None:
                file_level = None
            else:
                file_level |= rules
        else:
            per_line[lineno] = rules
    return per_line, file_level


def _suppressed(v: Violation, per_line: dict[int, set[str] | None],
                file_level: set[str] | None) -> bool:
    if file_level is None or v.rule in file_level:
        return True
    rules = per_line.get(v.line, set())
    return rules is None or v.rule in (rules or set())


def lint_source(source: str, path: str = "<string>", *,
                rel_module: str = "", rules: Sequence[str] | None = None,
                hot_path: bool | None = None,
                captured: Sequence[str] | None = None) -> list[Violation]:
    """Lint one source string (the unit-test entry point).

    ``rel_module`` is the package-relative posix path used for hot-path
    scoping and for ``CAPTURED_ENTRY_POINTS``; ``hot_path`` and
    ``captured`` override those decisions outright.  ``rules`` restricts
    the run to the named rules (default: all).
    """
    from repro_torch.analysis.rules import RULES

    tree = ast.parse(source, filename=path)
    ctx = FileContext(
        path=path,
        rel_module=rel_module,
        source=source,
        is_hot_path=_is_hot_path(rel_module) if hot_path is None else hot_path,
        captured=tuple(CAPTURED_ENTRY_POINTS.get(rel_module, ()) if captured is None
                       else captured),
    )
    selected = RULES if rules is None else {n: RULES[n] for n in rules}
    found: list[Violation] = []
    for rule in selected.values():
        found.extend(rule.check(tree, ctx))
    per_line, file_level = _pragma_suppressions(source)
    return sorted(
        (v for v in found if not _suppressed(v, per_line, file_level)),
        key=lambda v: (v.path, v.line, v.col, v.rule),
    )


def lint_paths(paths: Iterable[Path], root: Path, *,
               rules: Sequence[str] | None = None) -> LintReport:
    """Lint the given files, reporting paths relative to the repo root
    when possible (falling back to absolute)."""
    report = LintReport()
    repo_root = root.parent.parent if root.name == "repro_torch" else root
    for p in sorted(paths):
        rel_module = p.relative_to(root).as_posix()
        try:
            display = str(p.relative_to(repo_root))
        except ValueError:
            display = str(p)
        source = p.read_text()
        try:
            report.violations.extend(
                lint_source(source, display, rel_module=rel_module, rules=rules)
            )
        except SyntaxError as e:
            report.violations.append(Violation(
                rule="parse-error", path=display, line=e.lineno or 0,
                col=e.offset or 0, message=f"cannot parse: {e.msg}",
            ))
        report.files_checked += 1
    return report


def run_lint(root: Path | None = None, *,
             rules: Sequence[str] | None = None) -> LintReport:
    """Lint every ``.py`` file under ``root`` (default: the installed
    ``repro_torch`` package — library code only, not tests or scripts)."""
    root = root or default_root()
    files = [
        p for p in root.rglob("*.py") if "__pycache__" not in p.parts
    ]
    return lint_paths(files, root, rules=rules)
