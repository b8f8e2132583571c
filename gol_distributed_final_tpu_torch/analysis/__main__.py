"""CLI: ``python -m gol_distributed_final_tpu_torch.analysis [-json] [PATH]``.

Default target is the package itself (the self-hosting contract:
``scripts/check`` runs this and the tree must analyze clean). Exit 0 on
clean, 1 on any unsuppressed finding, 2 on usage errors (argparse).

``-json`` prints the machine form — findings, suppressed findings, and
the checker registry — to stdout and writes ``out/analysis.json``
(temp-name + atomic rename, the obs/doctor.py artifact posture) for
toolchain use.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import all_checkers, ast_checkers, concurrency_checkers
from .core import run

PACKAGE_ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gol_distributed_final_tpu_torch.analysis",
        description="AST invariant checkers + README name lints",
    )
    parser.add_argument(
        "path", nargs="?", default=None,
        help="tree to analyze (default: the installed package)",
    )
    parser.add_argument(
        "-json", dest="as_json", action="store_true",
        help="print machine-readable findings and write out/analysis.json",
    )
    parser.add_argument(
        "-out", default="out",
        help="artifact directory for -json (default out)",
    )
    parser.add_argument(
        "--checks", default=None, metavar="ID[,ID...]",
        help="run only these check ids",
    )
    parser.add_argument(
        "--no-lint", action="store_true",
        help="invariant checkers only (AST + lock-composition; skip the "
        "repo-level README lints)",
    )
    parser.add_argument(
        "--list", action="store_true", dest="list_checks",
        help="list checker ids and exit",
    )
    args = parser.parse_args(argv)

    checkers = (
        ast_checkers() + concurrency_checkers()
        if args.no_lint else all_checkers()
    )
    if args.checks:
        wanted = {s.strip() for s in args.checks.split(",") if s.strip()}
        unknown = wanted - {c.id for c in checkers}
        if unknown:
            parser.error(f"unknown check id(s): {', '.join(sorted(unknown))}")
        checkers = [c for c in checkers if c.id in wanted]
    if args.list_checks:
        for c in checkers:
            print(f"{c.id}: {c.description}")
        return 0

    root = pathlib.Path(args.path) if args.path else PACKAGE_ROOT
    if not root.exists():
        parser.error(f"no such path: {root}")
    # with_repo stays True under --no-lint: the lock-composition
    # checkers are repo-LEVEL (the graph spans modules) but they are
    # invariant checkers, not doc lints — the flag excluded the README
    # lints from `checkers` above, which is all it promises
    report = run(root, checkers=checkers, with_repo=True)
    if args.as_json:
        blob = json.dumps(report.to_json(), indent=1)
        print(blob)
        out_dir = pathlib.Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        artifact = out_dir / "analysis.json"
        tmp = artifact.with_name(artifact.name + ".tmp")
        tmp.write_text(blob + "\n")
        tmp.replace(artifact)
    else:
        print(report.render())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
