"""dktlint core for the port: findings, suppressions, baselines, and the
suite runner.

The framework is deliberately stdlib-only (``ast`` + ``tokenize``-free line
scanning) so the lint suite runs on hosts without torch or jax installed —
it reads repo *source*, never imports repo modules. This is the port's own
copy of the JAX package's ``analysis/core.py`` (the port imports nothing of
that package); the suppression syntax and the baseline file format are the
same byte for byte, and the scan set is the port's files. Checkers subclass :class:`Checker`
and receive every parsed module in the scan set; cross-module invariants
(wire protocols, lock-order cycles, import layering, the telemetry registry)
fall out naturally from that shape.

Suppression syntax, modeled on flake8's ``noqa`` but rule-scoped::

    sock.sendall(buf)  # dktlint: disable=lock-blocking-call -- pipelined send

A suppression comment on its own line applies to the next source line. A
``# dktlint: disable-file=<rule>`` comment anywhere in a file suppresses the
rule for the whole file. Baselines are JSON fingerprint sets (rule + path +
normalized line content, so findings survive unrelated line drift); a
baselined finding is reported separately and does not fail the run.
"""

from __future__ import annotations

import ast
import glob
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

__all__ = [
    "Finding", "ModuleInfo", "Checker", "Report",
    "collect_modules", "parse_module", "module_from_source", "run_suite",
    "load_baseline", "write_baseline", "fingerprint", "dotted_name",
    "DEFAULT_SCAN_ROOTS", "EXCLUDE_PARTS", "ROOT_SCRIPTS",
]

# The port's root scripts: the card smoke, the benchmark line and the A/B
# scripts. They take the place that ``benchmarks/`` has in the JAX scan.
ROOT_SCRIPTS = ("chip_smoke.py", "bench_torch.py", "ab_driver.py",
                "groupnorm_ab.py", "int8_ab.py", "serving_ab.py")

# What enters the scan set, relative to the repo root: a directory (its .py
# files, recursively) or a file glob. The JAX package's files and tests are
# the JAX suite's business.
DEFAULT_SCAN_ROOTS = ("distkeras_tpu_torch", "tests/test_torch_*.py",
                      "tests/torch_multiprocess_worker.py") + ROOT_SCRIPTS

# Path fragments excluded from every checker: the lint suite itself (its
# config embeds metric/op names as data) and its fixture-bearing tests
# (known-bad snippets live there as string literals).
EXCLUDE_PARTS = (
    "distkeras_tpu_torch/analysis/",
    "tests/test_torch_analysis.py",
    "tests/test_torch_lint_clean.py",
)

_SUPPRESS_RE = re.compile(
    r"#\s*dktlint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclass
class ModuleInfo:
    path: str                    # absolute
    relpath: str                 # repo-relative, posix separators
    source: str
    tree: Optional[ast.AST]      # None when the file failed to parse
    lines: List[str]
    parse_error: Optional[str] = None
    # line -> set of rule names suppressed on that line ("*" = all)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    file_suppressions: Set[str] = field(default_factory=set)

    def is_suppressed(self, finding: Finding) -> bool:
        for rule in (finding.rule, "*"):
            if rule in self.file_suppressions:
                return True
        for line in (finding.line, finding.line - 1):
            rules = self.suppressions.get(line)
            if not rules:
                continue
            # a standalone comment line suppresses the line below it; an
            # inline comment suppresses its own line only
            if line == finding.line - 1 and not self._comment_only(line):
                continue
            if finding.rule in rules or "*" in rules:
                return True
        return False

    def _comment_only(self, line: int) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        return self.lines[line - 1].lstrip().startswith("#")


class Checker:
    """Base class. Subclasses set ``name`` + ``rules`` and implement
    :meth:`check` over the full scan set (cross-module view)."""

    name: str = "base"
    rules: Sequence[str] = ()

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        raise NotImplementedError


@dataclass
class Report:
    findings: List[Finding]          # unsuppressed, unbaselined -> failures
    suppressed: List[Finding]
    baselined: List[Finding]
    checked_files: int
    per_checker_files: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings


def _find_suppressions(source: str) -> tuple:
    per_line: Dict[int, Set[str]] = {}
    per_file: Set[str] = set()
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        if m.group(1) == "disable-file":
            per_file |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return per_line, per_file


def parse_module(path: str, root: str) -> ModuleInfo:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    mod = module_from_source(
        source, os.path.relpath(path, root).replace(os.sep, "/"))
    mod.path = path
    return mod


def module_from_source(source: str, relpath: str) -> ModuleInfo:
    """Build a ModuleInfo straight from a source string (fixture tests,
    editor integrations) — same parsing/suppression path as files."""
    tree, err = None, None
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        err = f"{e.msg} (line {e.lineno})"
    per_line, per_file = _find_suppressions(source)
    return ModuleInfo(path=relpath, relpath=relpath, source=source,
                      tree=tree, lines=source.splitlines(),
                      parse_error=err, suppressions=per_line,
                      file_suppressions=per_file)


def _excluded(rel: str) -> bool:
    return any(part in rel for part in EXCLUDE_PARTS)


def _scan_paths(root: str, scan_roots: Sequence[str]) -> List[str]:
    """The .py files under each directory entry, recursively, and the
    files each glob entry matches, in entry order."""
    paths: List[str] = []
    for sub in scan_roots:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            paths.extend(p for p in sorted(glob.glob(base))
                         if p.endswith(".py") and os.path.isfile(p))
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            paths.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                         if fn.endswith(".py"))
    return paths


def collect_modules(root: str,
                    scan_roots: Sequence[str] = DEFAULT_SCAN_ROOTS,
                    ) -> List[ModuleInfo]:
    modules: List[ModuleInfo] = []
    for path in _scan_paths(root, scan_roots):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        if _excluded(rel):
            continue
        modules.append(parse_module(path, root))
    return modules


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.nn.functional.softmax`` -> "torch.nn.functional.softmax";
    None for non-name expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# baseline


def fingerprint(finding: Finding, modules_by_path: Dict[str, ModuleInfo],
                ) -> str:
    mod = modules_by_path.get(finding.path)
    content = ""
    if mod and 1 <= finding.line <= len(mod.lines):
        content = mod.lines[finding.line - 1].strip()
    h = hashlib.sha1(
        f"{finding.rule}::{finding.path}::{content}".encode()).hexdigest()
    return h[:16]


def load_baseline(path: str) -> Set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return set(data.get("fingerprints", []))


def write_baseline(path: str, findings: Iterable[Finding],
                   modules_by_path: Dict[str, ModuleInfo]) -> None:
    fps = sorted({fingerprint(f, modules_by_path) for f in findings})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "tool": "dktlint", "fingerprints": fps},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")


# ---------------------------------------------------------------------------
# runner


def default_checkers() -> List[Checker]:
    # local imports: keep core importable by checker modules without cycles
    from distkeras_tpu_torch.analysis.layering import LayeringChecker
    from distkeras_tpu_torch.analysis.locks import LockDisciplineChecker
    from distkeras_tpu_torch.analysis.registry import (
        PrecisionPinChecker, TelemetryRegistryChecker)
    from distkeras_tpu_torch.analysis.wire import WireProtocolChecker
    return [LockDisciplineChecker(), WireProtocolChecker(),
            TelemetryRegistryChecker(), PrecisionPinChecker(),
            LayeringChecker()]


def run_suite(root: str,
              checkers: Optional[Sequence[Checker]] = None,
              baseline_path: Optional[str] = None,
              modules: Optional[List[ModuleInfo]] = None) -> Report:
    if checkers is None:
        checkers = default_checkers()
    if modules is None:
        modules = collect_modules(root)
    by_path = {m.relpath: m for m in modules}
    baseline = load_baseline(baseline_path) if baseline_path else set()

    findings: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    per_checker: Dict[str, int] = {}
    for checker in checkers:
        raw = checker.check(modules)
        per_checker[checker.name] = len(modules)
        for f in raw:
            mod = by_path.get(f.path)
            if mod is not None and mod.is_suppressed(f):
                suppressed.append(f)
            elif fingerprint(f, by_path) in baseline:
                baselined.append(f)
            else:
                findings.append(f)
    # parse failures are always findings (nothing else can run on the file)
    for m in modules:
        if m.parse_error:
            findings.append(Finding("parse-error", m.relpath, 1, 0,
                                    m.parse_error))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=findings, suppressed=suppressed,
                  baselined=baselined, checked_files=len(modules),
                  per_checker_files=per_checker)
