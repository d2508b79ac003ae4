"""``python -m repro_torch.analysis``: the port's lint pass, plus ruff
when it is installed (counterpart of ``repro/analysis/cli.py``).

Exit status: 0 on a clean tree, 1 when any finding (or ruff error)
remains, 2 on usage errors.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import lint

DEFAULT_PATHS = ("src/repro_torch", "examples/torch")


def _parse_rules(text: Optional[str]) -> Optional[List[str]]:
    if not text:
        return None
    return [p.strip() for p in text.split(",") if p.strip()]


def list_rules() -> str:
    lint._ensure_builtin_checkers()
    lines = []
    for name in lint.available_checkers():
        checker = lint.get_checker(name)
        lines.append(f"[{name}]")
        for rule in checker.rules:
            lines.append(f"  {rule}  {lint.RULES[rule]}")
    return "\n".join(lines)


def run_ruff(paths: Sequence[str]) -> Optional[int]:
    """Run ruff over ``paths`` if it is installed; None when absent."""
    exe = shutil.which("ruff")
    if exe is None:
        return None
    proc = subprocess.run([exe, "check", *paths])
    return proc.returncode


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's hot-path lint (+ ruff when installed)")
    parser.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                        help="files or directories (default: "
                             "src/repro_torch examples/torch)")
    parser.add_argument("--select", help="comma-separated rule ids to "
                                         "run exclusively")
    parser.add_argument("--ignore", help="comma-separated rule ids to "
                                         "skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--no-ruff", action="store_true",
                        help="skip the ruff step even if installed")
    parser.add_argument("--root", default=None,
                        help="project root for module naming (default: "
                             "cwd)")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    findings = lint.lint_paths(args.paths, root=args.root,
                               select=_parse_rules(args.select),
                               ignore=_parse_rules(args.ignore))
    for f in findings:
        print(f.render())
    status = 1 if findings else 0
    print(f"repro-lint: {len(findings)} finding(s)")

    if not args.no_ruff:
        ruff_status = run_ruff(args.paths)
        if ruff_status is None:
            print("repro-lint: ruff not installed, skipping generic "
                  "lint step")
        elif ruff_status != 0:
            status = 1
    return status


if __name__ == "__main__":
    sys.exit(main())
