"""``python -m repro_torch.analysis`` — the port's tracecheck CLI, ported
from ``repro.analysis.__main__``.

Runs the AST lint over the ``repro_torch`` package and (unless
``--lint-only``) the contract checks on ``--device`` (default: the
card; it raises without one), printing human-readable findings or a
machine-readable JSON report (``--json``).  Exits non-zero on any
violation or failed contract; on the card, where every contract can
run, a skipped contract fails too:

    python -m repro_torch.analysis                  # lint + contracts on the card
    python -m repro_torch.analysis --device cpu     # the CPU contracts
    python -m repro_torch.analysis --lint-only --rules no-global-rng
    python -m repro_torch.analysis --list           # rule catalog

The lint alone imports no torch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracecheck: static + capture/sync contract verification",
    )
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON report on stdout")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the contract checks (no torch needed)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--list", action="store_true",
                    help="list the lint rules and exit")
    ap.add_argument("--root", type=Path, default=None,
                    help="lint this directory instead of the repro_torch package")
    ap.add_argument("--rules", default=None,
                    help="comma-separated lint-rule subset")
    ap.add_argument("--device", default="cuda",
                    help="where the contracts run: cuda (default; raises without a "
                         "card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.analysis import rule_catalog, run_lint

    if args.list:
        for name, desc in rule_catalog():
            print(f"{name:24s} {desc}")
        return 0
    if args.lint_only and args.contracts_only:
        ap.error("--lint-only and --contracts-only are mutually exclusive")

    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )

    payload: dict = {}
    ok = True

    if not args.contracts_only:
        lint = run_lint(args.root, rules=rules)
        payload["lint"] = lint.to_dict()
        ok &= lint.ok
        if not args.json:
            for v in lint.violations:
                print(v)
            print(
                f"lint: {len(lint.violations)} violation(s) across "
                f"{lint.files_checked} files"
            )

    if not args.lint_only:
        # Imported here: the contracts need torch and build tiny engines.
        from repro_torch.analysis.contracts import run_contracts

        contracts = run_contracts(args.device)
        payload["contracts"] = contracts.to_dict()
        ok &= contracts.ok
        if not args.json:
            for r in contracts.results:
                print(r)
            n_fail = sum(1 for r in contracts.results if not contracts.passed(r))
            print(f"contracts: {n_fail} failure(s) of {len(contracts.results)} checks "
                  f"on {contracts.device}")

    payload["ok"] = ok
    if args.json:
        print(json.dumps(payload, indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
