"""The port's dktlint CLI: ``python -m distkeras_tpu_torch.analysis
[--root DIR]``.

Exit codes: 0 = clean, 1 = unsuppressed findings, 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from distkeras_tpu_torch.analysis.core import (collect_modules,
                                               default_checkers, run_suite,
                                               write_baseline)

DEFAULT_BASELINE = ".dktlint-torch-baseline.json"

#: why the JAX suite's jit-purity rules have no counterpart here
JIT_PURITY_NOTE = (
    "jit-purity (jit-host-effect, jit-closure-mutation, jit-tracer-branch) "
    "is not ported: its targets are functions handed to a JAX tracer "
    "(jax.jit, shard_map, the lax loops, pl.pallas_call), and the port "
    "hands none to a tracer (no torch.compile, torch.jit or triton.jit); "
    "its one CUDA-graph capture takes its body as a parameter, which a "
    "lexical checker cannot follow")


def _detect_root(start: str) -> str:
    """Walk up from start looking for the repo root (pyproject.toml)."""
    cur = os.path.abspath(start)
    while True:
        if os.path.exists(os.path.join(cur, "pyproject.toml")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.analysis",
        description="dktlint for the port: project-specific static "
                    "analysis (lock discipline, wire protocols, telemetry "
                    "registry, precision pins, import layering)")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: auto-detect from "
                         "cwd via pyproject.toml)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON path (default: "
                         f"<root>/{DEFAULT_BASELINE} when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings: write them to the "
                         "baseline and exit 0")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every checker and rule id, then exit")
    args = ap.parse_args(argv)

    checkers = default_checkers()
    if args.list_rules:
        for c in checkers:
            for r in c.rules:
                print(f"{c.name}: {r}")
        print(f"# {JIT_PURITY_NOTE}")
        return 0

    root = args.root or _detect_root(os.getcwd())
    baseline = None
    if not args.no_baseline:
        baseline = args.baseline or os.path.join(root, DEFAULT_BASELINE)

    modules = collect_modules(root)
    if not modules:
        print(f"dktlint: no python sources under {root}", file=sys.stderr)
        return 2

    report = run_suite(root, checkers=checkers,
                       baseline_path=None if args.write_baseline
                       else baseline,
                       modules=modules)

    if args.write_baseline:
        path = baseline or os.path.join(root, DEFAULT_BASELINE)
        write_baseline(path, report.findings,
                       {m.relpath: m for m in modules})
        print(f"dktlint: wrote {len(report.findings)} fingerprint(s) to "
              f"{path}")
        return 0

    if args.format == "json":
        print(json.dumps({
            "findings": [f.__dict__ for f in report.findings],
            "suppressed": len(report.suppressed),
            "baselined": len(report.baselined),
            "checked_files": report.checked_files,
        }, indent=2))
    else:
        for f in report.findings:
            print(f.render())
        print(f"dktlint: {len(report.findings)} finding(s), "
              f"{len(report.suppressed)} suppressed, "
              f"{len(report.baselined)} baselined, "
              f"{report.checked_files} files checked")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
