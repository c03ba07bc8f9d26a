"""The port's dktlint gate (tier-1): the JAX gate's checks
(tests/test_lint_clean.py) run on ``distkeras_tpu_torch/``, its tests and
its root scripts.

``python -m distkeras_tpu_torch.analysis`` exits 0 on the repo with no
baseline at all, every checker scanned a non-trivial corpus (no vacuous
pass), the by-design patterns stay visible as suppressed findings, and
the suite itself runs without loading torch, jax or the JAX package.
"""

import fnmatch
import glob
import importlib
import json
import os
import subprocess
import sys

import pytest

from distkeras_tpu_torch.analysis.core import (EXCLUDE_PARTS, collect_modules,
                                               default_checkers, run_suite)
from distkeras_tpu_torch.analysis.layering import LAYER_RULES
from distkeras_tpu_torch.analysis.registry import load_declared_names
from distkeras_tpu_torch.analysis.wire import PROTOCOLS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distkeras_tpu_torch")

#: the corpus floor: the port's package, its tests and its root scripts
MIN_FILES = 150
#: the by-design patterns, suppressed inline beside their JAX twins
MIN_SUPPRESSED = 11

ANALYSIS_MODULES = sorted(
    "distkeras_tpu_torch.analysis." + os.path.basename(p)[:-3]
    for p in glob.glob(os.path.join(PKG, "analysis", "*.py"))
    if os.path.basename(p) not in ("__init__.py", "__main__.py"))


@pytest.fixture(scope="module")
def modules():
    return collect_modules(REPO)


@pytest.fixture(scope="module")
def report(modules):
    return run_suite(REPO, modules=modules)


def test_repo_lints_clean_with_no_baseline(report):
    assert report.findings == [], "\n" + "\n".join(
        f.render() for f in report.findings)
    assert report.baselined == []


def test_scan_is_not_vacuous(modules, report):
    assert report.checked_files >= MIN_FILES, report.checked_files
    rels = {m.relpath for m in modules}
    for must in ("distkeras_tpu_torch/telemetry.py",
                 "distkeras_tpu_torch/serving/server.py",
                 "distkeras_tpu_torch/parallel/remote_ps.py",
                 "distkeras_tpu_torch/health/endpoints.py",
                 "distkeras_tpu_torch/models/gpt.py",
                 "tests/test_torch_pipeline.py",
                 "tests/torch_multiprocess_worker.py",
                 "chip_smoke.py", "bench_torch.py"):
        assert must in rels, must
    # the lint suite and its fixture tests stay out of their own scan, and
    # the JAX package is the JAX gate's business
    for part in EXCLUDE_PARTS:
        assert not any(part in r for r in rels), part
    assert not any(r.startswith(("distkeras_tpu/", "benchmarks/"))
                   for r in rels)
    assert all(not r.startswith("tests/") or "torch" in r for r in rels)


def test_intentional_findings_are_suppressed_not_absent(report):
    """The by-design patterns (client sends under the connection lock,
    the fault injector's delay under the commit lock, the MoE -> tensor
    sharding bridge) must be *suppressed* findings: still visible to the
    checkers, justified inline. If a refactor removes the pattern, this
    floor drops — update it alongside."""
    assert len(report.suppressed) >= MIN_SUPPRESSED, [
        f.render() for f in report.suppressed]
    suppressed_rules = {f.rule for f in report.suppressed}
    assert "lock-blocking-call" in suppressed_rules
    assert "layer-forbidden-import" in suppressed_rules


def test_registry_is_populated_and_equals_the_runtime(modules):
    declared, prefixes = load_declared_names(modules)
    assert len(declared) >= 200, len(declared)
    assert "span." in prefixes and "observability.hbm_" in prefixes
    # the runtime reads the same literal (single source of truth)
    from distkeras_tpu_torch import telemetry
    assert telemetry.METRIC_NAMES == declared
    assert telemetry.METRIC_PREFIXES == prefixes
    assert telemetry.declared_kind("ps.commit.count") == "counter"


def test_layering_carries_the_framework_free_rule():
    """Every health module and telemetry.py is covered by a rule that
    forbids torch; every module of the package by one that forbids jax
    and the JAX package."""
    covered = [p for (p, forbidden, _) in LAYER_RULES if "torch" in forbidden]
    health = glob.glob(os.path.join(PKG, "health", "*.py"))
    assert len(health) >= 5
    for src in health + [os.path.join(PKG, "telemetry.py")]:
        rel = os.path.relpath(src, REPO).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, pat) for pat in covered), rel
    boundary = [p for (p, forbidden, _) in LAYER_RULES
                if {"jax", "distkeras_tpu"} <= set(forbidden)]
    for src in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        rel = os.path.relpath(src, REPO).replace(os.sep, "/")
        assert any(fnmatch.fnmatch(rel, pat) for pat in boundary), rel


def test_wire_config_names_all_four_servers():
    servers = {p for proto in PROTOCOLS for p in proto.server_paths}
    assert servers == {"distkeras_tpu_torch/parallel/remote_ps.py",
                       "distkeras_tpu_torch/serving/server.py",
                       "distkeras_tpu_torch/health/endpoints.py",
                       "distkeras_tpu_torch/data/service.py"}
    for proto in PROTOCOLS:
        for p in proto.server_paths + proto.client_paths:
            assert os.path.exists(os.path.join(REPO, p)), p


def test_no_baseline_is_committed():
    """The port lints clean outright: nothing is grandfathered."""
    assert not os.path.exists(
        os.path.join(REPO, ".dktlint-torch-baseline.json"))


def test_analysis_discovery_found_the_checkers():
    assert ANALYSIS_MODULES == [
        f"distkeras_tpu_torch.analysis.{name}"
        for name in ("core", "layering", "locks", "registry", "wire")]


@pytest.mark.parametrize("module", ANALYSIS_MODULES)
def test_import_analysis_module(module):
    assert importlib.import_module(module) is not None


def test_every_rule_belongs_to_exactly_one_checker():
    seen = {}
    for checker in default_checkers():
        for rule in checker.rules:
            assert rule not in seen, (rule, seen[rule], checker.name)
            seen[rule] = checker.name
    assert len(seen) == 10, seen


def test_cli_in_a_fresh_interpreter_loads_no_framework():
    """The suite reads source only: running it loads no torch, jax, flax
    nor anything of the JAX package."""
    code = (
        "import json, sys\n"
        "from distkeras_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--root', sys.argv[1], '--format', 'json'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'flax', 'distkeras_tpu'))\n"
        "print(json.dumps({'rc': rc, 'loaded': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code, REPO],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report, _, tail = proc.stdout.rpartition("\n{")
    out = json.loads("{" + tail)
    assert out == {"rc": 0, "loaded": []}, out
    summary = json.loads(report)
    assert summary["findings"] == [] and summary["baselined"] == 0
    assert summary["checked_files"] >= MIN_FILES
