"""dktlint for the port: every rule gets known-bad snippets (true
positives asserted) and known-good ones (no false positive) in the port's
idiom, plus the suppression forms, the baseline round trip and the CLI's
exit codes. Then the port's suite is held against the JAX package's on
the same inputs (wire extraction over each package's own servers and
clients, the core's suppressions, fingerprints and baseline files, the
registry's declared names), and each checker must catch a mutation of a
real port file.

Fixture sources live in multi-line strings (the JAX gate scans this file
for metric-shaped literals), and the suppression marker is spelled only
through ``_src``."""

import io
import json
import os
import re
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import pytest

from distkeras_tpu.analysis import core as jcore
from distkeras_tpu.analysis import registry as jregistry
from distkeras_tpu.analysis import wire as jwire
from distkeras_tpu_torch.analysis import core, registry, wire
from distkeras_tpu_torch.analysis.__main__ import main
from distkeras_tpu_torch.analysis.layering import LayeringChecker
from distkeras_tpu_torch.analysis.locks import LockDisciplineChecker
from distkeras_tpu_torch.analysis.registry import (PrecisionPinChecker,
                                                   TelemetryRegistryChecker)
from distkeras_tpu_torch.analysis.wire import Protocol, WireProtocolChecker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "dktlint" + ":"

RULES = ("lock-blocking-call", "lock-order-cycle", "wire-unhandled-op",
         "wire-unreferenced-op", "wire-error-kind-drift",
         "telemetry-undeclared-name", "telemetry-kind-mismatch",
         "telemetry-unknown-consumer-name", "precision-f32-pin",
         "layer-forbidden-import")


def _src(text):
    """A fixture's source: dedented, ``<S>`` spelled as the marker."""
    return textwrap.dedent(text).replace("<S>", MARK)


def _check(checker, *mods):
    """Run one checker over source-string modules; return rule names."""
    modules = [core.module_from_source(_src(src), rel) for rel, src in mods]
    return [f.rule for f in checker.check(modules)]


@pytest.fixture(scope="module")
def port_modules():
    return core.collect_modules(REPO)


# -- locks -------------------------------------------------------------------

_LOCK_CASES = {
    "socket-sendall": ("""
        import threading

        class S:
            def __init__(self, sock):
                self._lock = threading.Lock()
                self._sock = sock

            def send(self, payload):
                with self._lock:
                    self._sock.sendall(payload)
    """, 1),
    # the port's framing names: remote_ps's send/recv and their chunked
    # halves, the checkpointer's wait (Orbax's wait_until_finished)
    "port-framing-and-checkpoint-wait": ("""
        import threading
        from distkeras_tpu_torch.comms.chunking import send_buffers
        from distkeras_tpu_torch.parallel.remote_ps import (
            _recvexact, send_message)

        class S:
            def __init__(self, sock, ckpt):
                self._lock = threading.Lock()
                self._sock = sock
                self._ckpt = ckpt

            def send(self, header, blobs):
                with self._lock:
                    send_message(self._sock, header, blobs)
                    send_buffers(self._sock, blobs)
                    _recvexact(self._sock, 4)
                    self._ckpt.wait()
    """, 4),
    "held-cv-wait-good": ("""
        import threading

        class S:
            def __init__(self, sock):
                self._cv = threading.Condition()
                self._sock = sock
                self.items = []

            def send(self, payload):
                with self._cv:
                    # waiting on the HELD cv releases it: not blocking
                    self._cv.wait_for(lambda: bool(self.items))
                    item = self.items.pop()
                self._sock.sendall(item)  # outside the lock: fine
    """, 0),
}


@pytest.mark.parametrize("case", sorted(_LOCK_CASES))
def test_lock_blocking_call(case):
    src, n = _LOCK_CASES[case]
    rules = _check(LockDisciplineChecker(), ("distkeras_tpu_torch/x.py", src))
    assert rules == ["lock-blocking-call"] * n


_ORDER = """
    import threading
    A = threading.Lock()
    B = threading.Lock()

    def fwd():
        with A:
            with B:
                pass

    def rev():
        with {}:
            with {}:
                pass
"""


@pytest.mark.parametrize("second,cycle", [(("B", "A"), True),
                                          (("A", "B"), False)])
def test_lock_order_cycle(second, cycle):
    rules = _check(LockDisciplineChecker(),
                   ("distkeras_tpu_torch/x.py", _ORDER.format(*second)))
    assert ("lock-order-cycle" in rules) == cycle


def test_locks_scope_is_the_port():
    src, _ = _LOCK_CASES["socket-sendall"]
    assert _check(LockDisciplineChecker(), ("tests/test_torch_x.py", src)) == []


# -- wire protocol -----------------------------------------------------------

def _wire_checker():
    return WireProtocolChecker(protocols=(Protocol(
        name="demo",
        server_paths=("distkeras_tpu_torch/srv.py",),
        client_paths=("distkeras_tpu_torch/cli.py",)),))


_CLIENT_PULL_COMMIT = """
    class C:
        def go(self):
            self._roundtrip({"op": "pull"})
            self._roundtrip({"op": "commit"})
"""

_WIRE_CASES = {
    "typo-unhandled": ("""
        def dispatch(conn, header):
            op = header.get("op")
            if op == "pull":
                pass
    """, """
        class C:
            def pull(self):
                return self._roundtrip({"op": "pull"})

            def commit(self):
                return self._roundtrip({"op": "comit"})  # typo
    """, ["wire-unhandled-op"]),
    "unreferenced": ("""
        def dispatch(conn, header):
            op = header.get("op")
            if op == "pull":
                pass
            elif op == "legacy_reset":
                pass
    """, """
        class C:
            def pull(self):
                return self._roundtrip({"op": "pull"})
    """, ["wire-unreferenced-op"]),
    "named-tuple-clean": ("""
        OPS = ("pull", "commit")

        def dispatch(conn, header):
            op = header.get("op")
            if op in OPS:
                pass
    """, _CLIENT_PULL_COMMIT, []),
    # the port's dispatch table (serving/server.py's _dispatch)
    "table-indexed-clean": ("""
        class Srv:
            def _dispatch(self, conn, header, blobs):
                op = header.get("op")
                handlers = {"pull": self._pull, "commit": self._commit}
                if op in handlers:
                    handlers[op](conn, header, blobs)
    """, _CLIENT_PULL_COMMIT, []),
    "table-get-clean": ("""
        class Srv:
            def _dispatch(self, conn, header):
                fn = {"pull": self._pull, "commit": self._commit}
                handler = fn.get(header.get("op"))
                return handler(conn, header)
    """, _CLIENT_PULL_COMMIT, []),
    "table-missing-key": ("""
        class Srv:
            def _dispatch(self, conn, header, blobs):
                op = header.get("op")
                handlers = {"pull": self._pull}
                handlers[op](conn, header, blobs)
    """, _CLIENT_PULL_COMMIT, ["wire-unhandled-op"]),
    # a dict that is not looked up by op (here: by another name, or in
    # another function) is no dispatch table
    "table-not-looked-up-by-op": ("""
        class Srv:
            def _dispatch(self, conn, header, blobs):
                handlers = {"pull": self._pull, "commit": self._commit}
                return handlers[header.get("kind")](conn)

            def other(self, op):
                return op
    """, _CLIENT_PULL_COMMIT, ["wire-unhandled-op", "wire-unhandled-op"]),
}


@pytest.mark.parametrize("case", sorted(_WIRE_CASES))
def test_wire_ops(case):
    server, client, want = _WIRE_CASES[case]
    rules = _check(_wire_checker(), ("distkeras_tpu_torch/srv.py", server),
                   ("distkeras_tpu_torch/cli.py", client))
    assert rules == want


def test_wire_error_kind_drift_detected_on_repo_shape():
    # simulate drift by declaring a kind the server never emits
    rules = _check(WireProtocolChecker(protocols=()), (
        "distkeras_tpu_torch/serving/server.py", """
        ERROR_KINDS = ("deadline", "ghost_kind")

        def _error_kind(exc):
            return "deadline"
    """))
    assert rules == ["wire-error-kind-drift"]


# -- telemetry registry ------------------------------------------------------

# the checker reads METRIC_NAMES/METRIC_PREFIXES from this module's AST
_TELEMETRY_STUB = ("distkeras_tpu_torch/telemetry.py", """
    METRIC_NAMES = {
        "ps.commit.count": "counter",
        "serving.queue_depth": "gauge",
    }
    METRIC_PREFIXES = {
        "span.": "histogram",
    }
""")

_TELEMETRY_CASES = {
    "undeclared-producer": ("distkeras_tpu_torch/a.py", """
        from distkeras_tpu_torch import telemetry
        telemetry.counter("ps.commit.cnt").inc()  # typo'd name
    """, "telemetry-undeclared-name"),
    "undeclared-fstring-in-a-script": ("chip_smoke.py", """
        from distkeras_tpu_torch import telemetry
        calls = [telemetry.counter(f"ps.{k}").value for k in ("a", "b")]
    """, "telemetry-undeclared-name"),
    "kind-mismatch": ("distkeras_tpu_torch/a.py", """
        from distkeras_tpu_torch import telemetry
        telemetry.gauge("ps.commit.count").set(1)
    """, "telemetry-kind-mismatch"),
    "consumer-drift": ("distkeras_tpu_torch/health/export.py", """
        def read(snapshot):
            return snapshot["gauges"].get("serving.queue_depht")  # typo
    """, "telemetry-unknown-consumer-name"),
    "consumer-drift-in-a-port-test": ("tests/test_torch_x.py", """
        def test_x(snapshot):
            assert snapshot["gauges"]["serving.queue_depht"] == 0
    """, "telemetry-unknown-consumer-name"),
    "clean": ("distkeras_tpu_torch/a.py", """
        from distkeras_tpu_torch import telemetry
        telemetry.counter("ps.commit.count").inc()
        telemetry.gauge("serving.queue_depth").set(0)
        telemetry.histogram(f"span.x.duration_s").record(1.0)

        def read(snapshot):
            return snapshot["gauges"].get("serving.queue_depth")
    """, None),
}


@pytest.mark.parametrize("case", sorted(_TELEMETRY_CASES))
def test_telemetry_registry(case):
    rel, src, want = _TELEMETRY_CASES[case]
    rules = _check(TelemetryRegistryChecker(), _TELEMETRY_STUB, (rel, src))
    assert rules == ([want] if want else [])


# -- precision ---------------------------------------------------------------

_PRECISION_CASES = {
    # (a) f32-pinned modules built in another dtype
    "a-bad": ("""
        import torch
        from torch import nn
        from distkeras_tpu_torch.models.transformer import Dense

        class M(nn.Module):
            def __init__(self, w, dtype):
                super().__init__()
                self.ln = nn.LayerNorm(w, dtype=torch.bfloat16)
                self.lm_head = nn.Linear(w, 10, dtype=dtype)
                self.router = Dense(w, 4, torch.bfloat16)
                self.norm = torch.nn.LayerNorm(w, 1e-6, True, True, None,
                                               torch.float16)
    """, 4),
    "a-good": ("""
        import torch
        from torch import nn
        from distkeras_tpu_torch.models.transformer import Dense

        class M(nn.Module):
            def __init__(self, w, dtype):
                super().__init__()
                self.ln1 = nn.LayerNorm(w, eps=1e-6)
                self.ln2 = nn.LayerNorm(w, dtype=torch.float32)
                self.lm_head = nn.Linear(w, 10)
                self.head = Dense(w, 10, torch.float32)
                self.qkv = Dense(w, 3 * w, dtype)  # not a head: free
    """, 0),
    # (b) pinned modules called on inputs that are not float32-rooted
    "b-bad": ("""
        from torch import nn

        class M(nn.Module):
            def __init__(self, w):
                super().__init__()
                self.ln_final = nn.LayerNorm(w)
                self.head = nn.Linear(w, 10)
                self.router = nn.Linear(w, 4)

            def forward(self, x, y):
                h = self.ln_final(x)
                logits = self.router(x.to(self.router.weight.device))
                return self.head(h[:, 0] + y), logits
    """, 3),
    "b-good": ("""
        import torch
        from torch import nn

        class M(nn.Module):
            def __init__(self, w):
                super().__init__()
                self.ln_final = nn.LayerNorm(w)
                self.ln1 = nn.LayerNorm(w)
                self.lm_head = nn.Linear(w, 10)
                self.head = nn.Linear(w, 10)

            def forward(self, x):
                y = self.ln1(x.to(torch.float32)).to(x.dtype)
                a = self.lm_head(self.ln_final(x.float()))
                b = self.head(x.float().mean(dim=1))
                c = self.head(y[:, 0].float())
                return a, b, c
    """, 0),
    # (c) softmax inputs explicitly cast down
    "c-bad": ("""
        import torch
        import torch.nn.functional as F

        def attn(logits, w):
            a = torch.softmax(logits.to(torch.bfloat16), dim=-1)
            b = F.log_softmax(logits.half(), dim=-1)
            c = (logits.bfloat16() * w).softmax(-1)
            d = F.softmax(logits.to(dtype=torch.float16), dim=-1)
            return a, b, c, d
    """, 4),
    "c-good": ("""
        import torch
        import torch.nn.functional as F

        def attn(logits, dtype):
            a = torch.softmax(logits, dim=-1).to(dtype)  # output cast
            b = F.log_softmax(logits.float(), dim=-1)
            c = logits.to(torch.float32).softmax(-1).to(torch.bfloat16)
            return a, b, c
    """, 0),
}


@pytest.mark.parametrize("case", sorted(_PRECISION_CASES))
def test_precision_pin(case):
    src, n = _PRECISION_CASES[case]
    rules = _check(PrecisionPinChecker(), ("distkeras_tpu_torch/models/m.py",
                                           src))
    assert rules == ["precision-f32-pin"] * n


def test_precision_scope_is_models_and_ops():
    for case in ("a-bad", "b-bad", "c-bad"):
        src, _ = _PRECISION_CASES[case]
        assert _check(PrecisionPinChecker(), (
            "distkeras_tpu_torch/parallel/p.py", src)) == []
    src, n = _PRECISION_CASES["c-bad"]
    assert len(_check(PrecisionPinChecker(), (
        "distkeras_tpu_torch/ops/a.py", src))) == n


# -- layering ----------------------------------------------------------------

_LAYER_CASES = [
    ("distkeras_tpu_torch/health/probe.py", "import torch\n", True),
    # lazy imports are still imports
    ("distkeras_tpu_torch/health/probe.py",
     "def f():\n    import torch\n    return torch.zeros(3)\n", True),
    ("distkeras_tpu_torch/health/probe.py", "import numpy as np\n", False),
    ("distkeras_tpu_torch/telemetry.py", "import torch\n", True),
    # comms quantizes torch tensors: only the reference stack is barred
    ("distkeras_tpu_torch/comms/codec.py", "import torch\n", False),
    ("distkeras_tpu_torch/comms/codec.py", "import ml_dtypes\n", True),
    ("distkeras_tpu_torch/serving/s.py",
     "from distkeras_tpu_torch.trainers import DOWNPOUR\n", True),
    ("distkeras_tpu_torch/models/m.py",
     "from distkeras_tpu_torch.parallel import substrate\n", True),
    # the port's boundary, anywhere in the package
    ("distkeras_tpu_torch/parallel/p.py", "import jax.numpy as jnp\n", True),
    ("distkeras_tpu_torch/utils/u.py",
     "from distkeras_tpu.utils import trees\n", True),
    ("distkeras_tpu_torch/parallel/p.py",
     "from distkeras_tpu_torch.parallel import tensor\n", False),
]


@pytest.mark.parametrize("rel,src,bad", _LAYER_CASES)
def test_layering(rel, src, bad):
    rules = _check(LayeringChecker(), (rel, src))
    assert ("layer-forbidden-import" in rules) == bad, rules
    assert set(rules) <= {"layer-forbidden-import"}


# -- suppressions ------------------------------------------------------------

_LOCKED_SEND = """
    import threading

    class S:
        def __init__(self, sock):
            self._lock = threading.Lock()
            self._sock = sock

        def send(self, payload):
            with self._lock:
                {}
"""

_SUPPRESSION_CASES = {
    "inline": (_LOCKED_SEND.format(
        "self._sock.sendall(payload)  # <S> disable=lock-blocking-call"),
        "distkeras_tpu_torch/x.py", LockDisciplineChecker, True),
    "standalone-line-above": (_LOCKED_SEND.format(
        "# <S> disable=lock-blocking-call\n"
        "                self._sock.sendall(payload)"),
        "distkeras_tpu_torch/x.py", LockDisciplineChecker, True),
    "rule-scoped": (_LOCKED_SEND.format(
        "self._sock.sendall(payload)  # <S> disable=some-other-rule"),
        "distkeras_tpu_torch/x.py", LockDisciplineChecker, False),
    "file-level": ("""
        # <S> disable-file=layer-forbidden-import
        import torch
    """, "distkeras_tpu_torch/health/probe.py", LayeringChecker, True),
}


@pytest.mark.parametrize("case", sorted(_SUPPRESSION_CASES))
def test_suppression_forms(case):
    src, rel, checker, suppressed = _SUPPRESSION_CASES[case]
    mod = core.module_from_source(_src(src), rel)
    findings = checker().check([mod])
    assert findings
    assert all(mod.is_suppressed(f) == suppressed for f in findings)


# -- baseline round-trip -----------------------------------------------------

def test_baseline_round_trip(tmp_path):
    src_dir = tmp_path / "distkeras_tpu_torch" / "health"
    src_dir.mkdir(parents=True)
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    bad = "import torch\n"
    (src_dir / "probe.py").write_text(bad)

    checkers = [LayeringChecker()]
    report = core.run_suite(str(tmp_path), checkers=checkers)
    assert [f.rule for f in report.findings] == ["layer-forbidden-import"]

    # accept into the baseline: the same finding no longer fails the run
    baseline = tmp_path / ".dktlint-torch-baseline.json"
    mods = {m.relpath: m for m in core.collect_modules(str(tmp_path))}
    core.write_baseline(str(baseline), report.findings, mods)
    again = core.run_suite(str(tmp_path), checkers=checkers,
                           baseline_path=str(baseline))
    assert again.findings == [] and len(again.baselined) == 1

    # a NEW finding still fails despite the baseline
    (src_dir / "probe.py").write_text(bad + "import jax\n")
    third = core.run_suite(str(tmp_path), checkers=checkers,
                           baseline_path=str(baseline))
    assert [f.message.split("`")[1] for f in third.findings] == [
        "import jax", "import jax"]  # the health rule and the boundary

    data = json.loads(baseline.read_text())
    assert data["version"] == 1 and len(data["fingerprints"]) == 1


def test_collect_modules_takes_globs(tmp_path):
    for rel in ("tests/test_torch_a.py", "tests/test_b.py",
                "tests/torch_multiprocess_worker.py", "chip_smoke.py",
                "distkeras_tpu_torch/x/y.py", "distkeras_tpu/z.py",
                "distkeras_tpu_torch/analysis/core.py",
                "tests/test_torch_analysis.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("x = 1\n")
    rels = [m.relpath for m in core.collect_modules(str(tmp_path))]
    assert sorted(rels) == ["chip_smoke.py", "distkeras_tpu_torch/x/y.py",
                            "tests/test_torch_a.py",
                            "tests/torch_multiprocess_worker.py"]


# -- CLI ---------------------------------------------------------------------

def _tree(tmp_path, rel, src):
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return str(tmp_path)


@pytest.mark.parametrize("rel,src,code", [
    ("distkeras_tpu_torch/health/probe.py", "import torch\n", 1),
    ("distkeras_tpu_torch/ok.py", "import numpy as np\n", 0),
    ("other/ok.py", "import numpy as np\n", 2),  # nothing to scan
])
def test_cli_exit_codes(tmp_path, rel, src, code):
    root = _tree(tmp_path, rel, src)
    assert main(["--root", root, "--no-baseline"]) == code


def test_cli_usage_error_exits_2():
    with pytest.raises(SystemExit) as e:
        main(["--format", "xml"])
    assert e.value.code == 2


def test_cli_write_baseline_then_clean(tmp_path):
    root = _tree(tmp_path, "distkeras_tpu_torch/health/probe.py",
                 "import torch\n")
    assert main(["--root", root, "--write-baseline"]) == 0
    assert os.path.exists(os.path.join(root, ".dktlint-torch-baseline.json"))
    assert main(["--root", root]) == 0  # baselined, not failing
    assert main(["--root", root, "--no-baseline"]) == 1


def test_cli_json_format(tmp_path):
    root = _tree(tmp_path, "distkeras_tpu_torch/health/probe.py",
                 "import torch\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--root", root, "--no-baseline",
                     "--format", "json"]) == 1
    out = json.loads(buf.getvalue())
    assert out["checked_files"] == 1 and out["suppressed"] == 0
    assert [f["rule"] for f in out["findings"]] == ["layer-forbidden-import"]


def test_cli_list_rules_names_exactly_the_ten_rules():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["--list-rules"]) == 0
    lines = buf.getvalue().splitlines()
    rules = [ln.split(": ", 1)[1] for ln in lines if not ln.startswith("#")]
    assert sorted(rules) == sorted(RULES)
    note = [ln for ln in lines if ln.startswith("#")]
    assert len(note) == 1 and "jit-purity" in note[0]
    assert "not ported" in note[0]


def test_module_invocation_smoke():
    """`python -m distkeras_tpu_torch.analysis` is the entry point."""
    proc = subprocess.run(
        [sys.executable, "-m", "distkeras_tpu_torch.analysis",
         "--list-rules"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "lock-blocking-call" in proc.stdout


# -- the port's suite against the JAX package's -------------------------------

def _protocol_sets(wire_mod, core_mod, pkg):
    """{protocol: (handled, sent)} and (declared, emitted) error kinds,
    from the package's own server and client modules."""
    paths = sorted({p for proto in wire_mod.PROTOCOLS
                    for p in proto.server_paths + proto.client_paths})
    mods = {p: core_mod.parse_module(os.path.join(REPO, p), REPO)
            for p in paths}
    assert all(p.startswith(pkg + "/") for p in paths), paths
    named = wire_mod._string_tuple_assignments(list(mods.values()))
    out = {}
    for proto in wire_mod.PROTOCOLS:
        handled = set().union(*(wire_mod._handled_ops(mods[p], named)
                                for p in proto.server_paths))
        sent = set().union(*(wire_mod._sent_ops(mods[p])
                             for p in proto.client_paths))
        out[proto.name] = (handled, sent, set(proto.client_only),
                           set(proto.server_only))
    kinds_mod = mods[wire_mod._ERROR_KINDS_MODULE]
    kinds = (set(named[wire_mod._ERROR_KINDS_NAME]),
             set(wire_mod._emitted_error_kinds(kinds_mod)))
    return out, kinds


@pytest.fixture(scope="module")
def wire_sets():
    return (_protocol_sets(wire, core, "distkeras_tpu_torch"),
            _protocol_sets(jwire, jcore, "distkeras_tpu"))


@pytest.mark.parametrize("proto", ["remote_ps", "serving", "data", "health"])
def test_wire_extraction_equals_jax(wire_sets, proto):
    (port, _), (ref, _) = wire_sets
    handled, sent, client_only, server_only = port[proto]
    assert handled and sent
    assert port[proto] == ref[proto]
    assert sent - client_only <= handled


def test_wire_error_kinds_equal_jax(wire_sets):
    (_, port), (_, ref) = wire_sets
    assert port == ref
    assert port[0] == port[1] and len(port[0]) == 5


_CORE_SOURCES = [
    _LOCKED_SEND.format(
        "self._sock.sendall(payload)  # <S> disable=lock-blocking-call"),
    "# <S> disable=lock-blocking-call,layer-forbidden-import\nimport a\n",
    "# <S> disable-file=*\nx = 1  # <S> disable=wire-unhandled-op , "
    "precision-f32-pin\n",
    "def f(:\n    pass\n",  # a parse error
]


@pytest.mark.parametrize("i", range(len(_CORE_SOURCES)))
def test_core_equals_jax_on_the_same_source(tmp_path, i):
    src = _src(_CORE_SOURCES[i])
    rel = "pkg/m.py"
    port = core.module_from_source(src, rel)
    ref = jcore.module_from_source(src, rel)
    assert port.suppressions == ref.suppressions
    assert port.file_suppressions == ref.file_suppressions
    assert (port.parse_error is None) == (ref.parse_error is None)
    lines = range(1, len(port.lines) + 2)
    fields = [("lock-blocking-call", rel, ln, 0, "m") for ln in lines]
    for f in fields:
        pf, rf = core.Finding(*f), jcore.Finding(*f)
        assert port.is_suppressed(pf) == ref.is_suppressed(rf)
        assert (core.fingerprint(pf, {rel: port})
                == jcore.fingerprint(rf, {rel: ref}))
    core.write_baseline(str(tmp_path / "port.json"),
                        [core.Finding(*f) for f in fields], {rel: port})
    jcore.write_baseline(str(tmp_path / "ref.json"),
                         [jcore.Finding(*f) for f in fields], {rel: ref})
    assert ((tmp_path / "port.json").read_bytes()
            == (tmp_path / "ref.json").read_bytes())


def test_registry_reads_the_jax_names():
    def declared(core_mod, registry_mod):
        mod = core_mod.parse_module(
            os.path.join(REPO, registry_mod._TELEMETRY_MODULE), REPO)
        return registry_mod.load_declared_names([mod])

    names, prefixes = declared(core, registry)
    assert (names, prefixes) == declared(jcore, jregistry)
    assert len(names) >= 200 and "span." in prefixes


# -- each checker catches a mutation of a real port file ----------------------

def _strip_marks(rule):
    return lambda s: re.sub(r"\s*# " + MARK + " disable=" + rule, "", s)


_MUTATIONS = {
    "locks": (LockDisciplineChecker, "distkeras_tpu_torch/serving/server.py",
              _strip_marks("lock-blocking-call"), "lock-blocking-call", 5),
    "wire": (WireProtocolChecker, "distkeras_tpu_torch/serving/server.py",
             lambda s: s.replace('"kv_export": self._kv_export,', ""),
             "wire-unhandled-op", 1),
    "telemetry": (TelemetryRegistryChecker,
                  "distkeras_tpu_torch/serving/server.py",
                  lambda s: s.replace('telemetry.counter("serving.server.r',
                                      'telemetry.gauge("serving.server.r'),
                  "telemetry-kind-mismatch", 1),
    "precision-input": (PrecisionPinChecker,
                        "distkeras_tpu_torch/models/gpt.py",
                        lambda s: s.replace("self.ln_final(x.float())",
                                            "self.ln_final(x)", 1),
                        "precision-f32-pin", 1),
    "precision-softmax": (PrecisionPinChecker,
                          "distkeras_tpu_torch/ops/attention.py",
                          lambda s: s.replace(
                              "torch.softmax(logits, dim=-1)",
                              "torch.softmax(logits.half(), dim=-1)"),
                          "precision-f32-pin", 1),
    "layering-health": (LayeringChecker,
                        "distkeras_tpu_torch/health/endpoints.py",
                        lambda s: s + "\nimport torch\n",
                        "layer-forbidden-import", 1),
    "layering-models": (LayeringChecker, "distkeras_tpu_torch/models/moe.py",
                        _strip_marks("layer-forbidden-import"),
                        "layer-forbidden-import", 1),
}


@pytest.mark.parametrize("case", sorted(_MUTATIONS))
def test_checker_catches_a_mutated_port_file(tmp_path, port_modules, case):
    checker, rel, mutate, rule, n = _MUTATIONS[case]
    clean = core.run_suite(REPO, checkers=[checker()], modules=port_modules)
    assert clean.findings == []
    with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
        src = fh.read()
    mutated = mutate(src)
    assert mutated != src
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(mutated, encoding="utf-8")
    mods = [core.parse_module(str(path), str(tmp_path)) if m.relpath == rel
            else m for m in port_modules]
    report = core.run_suite(REPO, checkers=[checker()], modules=mods)
    assert [(f.rule, f.path) for f in report.findings] == [(rule, rel)] * n
