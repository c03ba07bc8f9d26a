"""Wire-protocol consistency checker for the port.

The port's four socket servers share one length-prefixed framing and dispatch on a
stringly-typed ``header["op"]``; nothing but convention keeps the client
and server string sets equal. This checker extracts both sides from the
AST and fails on drift:

``wire-unhandled-op``
    A client sends an op string no server branch handles (typo'd op dies
    with an opaque "unknown op" error at runtime, possibly only on the
    card host).
``wire-unreferenced-op``
    A server handles an op no client in the repo ever sends — dead
    protocol surface, usually the stale half of a rename.
``wire-error-kind-drift``
    The serving protocol's error taxonomy: every ``"kind"`` value the
    server emits must be declared in ``ERROR_KINDS`` (serving/server.py)
    and vice versa — clients and tests dispatch on these strings.

Extraction rules (pure AST, per configured protocol):
- handled ops: ``op == "lit"`` / ``"lit" == op`` comparisons and
  ``op in ("a", "b")`` / ``op in HEALTH_OPS`` membership tests inside the
  server modules, where the compared name is ``op`` (the JAX package's
  dispatch idiom); named tuples like ``HEALTH_OPS`` are resolved from
  module-level assignments anywhere in the scan set. Also the port's
  dispatch table: the string keys of a dict literal of handlers bound to
  a name that the same function then indexes (``handlers[op]``) or
  ``.get``-s (``handlers.get(op)``) by ``op``.
- sent ops: ``{"op": "lit", ...}`` dict literals and ``self._call("lit")``
  calls inside the client modules.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

from distkeras_tpu_torch.analysis.core import (Checker, Finding,
                                               ModuleInfo, dotted_name)


@dataclass(frozen=True)
class Protocol:
    name: str
    server_paths: Tuple[str, ...]
    client_paths: Tuple[str, ...]
    # ops legal on exactly one side (e.g. server-initiated notifications)
    server_only: Tuple[str, ...] = ()
    client_only: Tuple[str, ...] = ()


PROTOCOLS: Tuple[Protocol, ...] = (
    # every socket server mounts the health introspection ops, whose
    # client lives in health/endpoints.py — it is a client of every server
    Protocol(
        name="remote_ps",
        # elastic.py drives the shard fleet through RemoteParameterServer
        # method calls today, but it is a client of this protocol — listed
        # so any op dict it grows (register/lease_renew/deregister/
        # shard_map fan-out) is checked against the server dispatch
        server_paths=("distkeras_tpu_torch/parallel/remote_ps.py",),
        # failover.py is the replication/lease client of the standby's
        # service (repl_append / coord_lease); its ops are part of this
        # protocol's surface
        client_paths=("distkeras_tpu_torch/parallel/remote_ps.py",
                      "distkeras_tpu_torch/parallel/elastic.py",
                      "distkeras_tpu_torch/parallel/failover.py",
                      "distkeras_tpu_torch/health/endpoints.py"),
    ),
    Protocol(
        name="serving",
        server_paths=("distkeras_tpu_torch/serving/server.py",),
        client_paths=("distkeras_tpu_torch/serving/server.py",
                      "distkeras_tpu_torch/health/endpoints.py"),
        # HealthClient is shared across every server; the fleet-telemetry
        # merge op and the coordinator-discovery op it uses to follow a
        # failover are mounted only on the PS services (remote_ps), and
        # the CLI catches the clean "unknown op" error and falls back
        client_only=("telemetry_merged", "coordinator"),
    ),
    Protocol(
        name="data",
        server_paths=("distkeras_tpu_torch/data/service.py",),
        client_paths=("distkeras_tpu_torch/data/service.py",
                      "distkeras_tpu_torch/health/endpoints.py"),
        # same HealthClient sharing as "serving": the fleet-merge and
        # coordinator-discovery ops are mounted only on the PS services
        client_only=("telemetry_merged", "coordinator"),
    ),
    Protocol(
        name="health",
        server_paths=("distkeras_tpu_torch/health/endpoints.py",),
        client_paths=("distkeras_tpu_torch/health/endpoints.py",),
        client_only=("telemetry_merged", "coordinator"),
    ),
)

# serving error taxonomy: declared tuple name and the module that owns it
_ERROR_KINDS_MODULE = "distkeras_tpu_torch/serving/server.py"
_ERROR_KINDS_NAME = "ERROR_KINDS"


def _string_tuple_assignments(modules: Sequence[ModuleInfo],
                              ) -> Dict[str, Tuple[str, ...]]:
    """Module-level NAME = ("a", "b", ...) assignments across the scan
    set, keyed by bare name (HEALTH_OPS etc.)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for mod in modules:
        if mod.tree is None:
            continue
        for node in ast.iter_child_nodes(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, (ast.Tuple, ast.List)):
                continue
            elts = node.value.elts
            if not elts or not all(isinstance(e, ast.Constant)
                                   and isinstance(e.value, str)
                                   for e in elts):
                continue
            vals = tuple(e.value for e in elts)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = vals
    return out


def _is_op_name(node: ast.expr) -> bool:
    # the dispatch idioms: `op == ...`, `header["op"] == ...`,
    # `header.get("op") == ...`
    if isinstance(node, ast.Name) and node.id == "op":
        return True
    if (isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "op"):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "op"):
        return True
    return False


def _own_nodes(fn: ast.AST):
    """Every node of ``fn``'s body, not descending into nested function,
    lambda or class bodies (those are functions of their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _dispatch_table_ops(fn: ast.AST) -> Dict[str, Tuple[int, int]]:
    """op -> (line, col) of its key, for each dict literal of handlers
    (string keys, no constant value) bound to a name that ``fn`` indexes
    or ``.get``-s by ``op``."""
    tables: Dict[str, ast.Dict] = {}
    used: Set[str] = set()
    for node in _own_nodes(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and node.value.keys
                and all(isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        for k in node.value.keys)
                and not any(isinstance(v, ast.Constant)
                            for v in node.value.values)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    tables[t.id] = node.value
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and _is_op_name(node.slice)):
            used.add(node.value.id)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get"
              and isinstance(node.func.value, ast.Name) and node.args
              and _is_op_name(node.args[0])):
            used.add(node.func.value.id)
    out: Dict[str, Tuple[int, int]] = {}
    for name in sorted(set(tables) & used):
        for k in tables[name].keys:
            out.setdefault(k.value, (k.lineno, k.col_offset))
    return out


def _handled_ops(mod: ModuleInfo,
                 named_tuples: Dict[str, Tuple[str, ...]],
                 ) -> Dict[str, Tuple[int, int]]:
    """op -> (line, col) for every server-side dispatch comparison and
    dispatch-table key."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for op, loc in _dispatch_table_ops(node).items():
                out.setdefault(op, loc)
            continue
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left, op, right = node.left, node.ops[0], node.comparators[0]
        loc = (node.lineno, node.col_offset)
        if isinstance(op, (ast.Eq, ast.NotEq)):
            for a, b in ((left, right), (right, left)):
                if (_is_op_name(a) and isinstance(b, ast.Constant)
                        and isinstance(b.value, str)):
                    out.setdefault(b.value, loc)
        elif isinstance(op, (ast.In, ast.NotIn)) and _is_op_name(left):
            if isinstance(right, (ast.Tuple, ast.List, ast.Set)):
                for e in right.elts:
                    if (isinstance(e, ast.Constant)
                            and isinstance(e.value, str)):
                        out.setdefault(e.value, loc)
            else:
                ref = dotted_name(right)
                if ref:
                    for v in named_tuples.get(ref.rsplit(".", 1)[-1], ()):
                        out.setdefault(v, loc)
    return out


def _sent_ops(mod: ModuleInfo) -> Dict[str, Tuple[int, int]]:
    """op -> (line, col) for client-side sends: {"op": "lit"} dict
    literals and self._call("lit") calls."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "op"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    out.setdefault(v.value, (node.lineno, node.col_offset))
        elif isinstance(node, ast.Call):
            fname = dotted_name(node.func)
            if fname and fname.rsplit(".", 1)[-1] == "_call" and node.args:
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out.setdefault(a.value,
                                   (node.lineno, node.col_offset))
    return out


def _emitted_error_kinds(mod: ModuleInfo) -> Dict[str, Tuple[int, int]]:
    """"kind" values the serving server emits: {"kind": "lit"} dict
    entries plus string returns of _error_kind()."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "kind"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)):
                    out.setdefault(v.value, (node.lineno, node.col_offset))
        elif (isinstance(node, ast.FunctionDef)
              and node.name == "_error_kind"):
            for ret in ast.walk(node):
                if (isinstance(ret, ast.Return)
                        and isinstance(ret.value, ast.Constant)
                        and isinstance(ret.value.value, str)):
                    out.setdefault(ret.value.value,
                                   (ret.lineno, ret.col_offset))
    return out


class WireProtocolChecker(Checker):
    name = "wire"
    rules = ("wire-unhandled-op", "wire-unreferenced-op",
             "wire-error-kind-drift")

    def __init__(self, protocols: Sequence[Protocol] = PROTOCOLS) -> None:
        self.protocols = tuple(protocols)

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        by_path = {m.relpath: m for m in modules if m.tree is not None}
        named_tuples = _string_tuple_assignments(modules)
        out: List[Finding] = []
        for proto in self.protocols:
            handled: Dict[str, Tuple[str, int, int]] = {}
            sent: Dict[str, Tuple[str, int, int]] = {}
            for p in proto.server_paths:
                mod = by_path.get(p)
                if mod is None:
                    continue
                for op, (ln, col) in _handled_ops(mod, named_tuples).items():
                    handled.setdefault(op, (p, ln, col))
            for p in proto.client_paths:
                mod = by_path.get(p)
                if mod is None:
                    continue
                for op, (ln, col) in _sent_ops(mod).items():
                    sent.setdefault(op, (p, ln, col))
            for op in sorted(set(sent) - set(handled)
                             - set(proto.client_only)):
                p, ln, col = sent[op]
                out.append(Finding(
                    "wire-unhandled-op", p, ln, col,
                    f"[{proto.name}] client sends op \"{op}\" but no "
                    "server branch handles it"))
            for op in sorted(set(handled) - set(sent)
                             - set(proto.server_only)):
                p, ln, col = handled[op]
                out.append(Finding(
                    "wire-unreferenced-op", p, ln, col,
                    f"[{proto.name}] server handles op \"{op}\" but no "
                    "client in the repo sends it — dead surface or a "
                    "renamed client side"))
        out.extend(self._check_error_kinds(by_path, named_tuples))
        return out

    def _check_error_kinds(self, by_path: Dict[str, ModuleInfo],
                           named_tuples: Dict[str, Tuple[str, ...]],
                           ) -> List[Finding]:
        mod = by_path.get(_ERROR_KINDS_MODULE)
        if mod is None:
            return []
        declared = set(named_tuples.get(_ERROR_KINDS_NAME, ()))
        if not declared:
            return [Finding(
                "wire-error-kind-drift", _ERROR_KINDS_MODULE, 1, 0,
                f"{_ERROR_KINDS_NAME} tuple not declared — the serving "
                "error taxonomy must be a single literal tuple")]
        emitted = _emitted_error_kinds(mod)
        out: List[Finding] = []
        for kind in sorted(set(emitted) - declared):
            ln, col = emitted[kind]
            out.append(Finding(
                "wire-error-kind-drift", mod.relpath, ln, col,
                f"server emits error kind \"{kind}\" missing from "
                f"{_ERROR_KINDS_NAME}"))
        for kind in sorted(declared - set(emitted)):
            out.append(Finding(
                "wire-error-kind-drift", mod.relpath, 1, 0,
                f"{_ERROR_KINDS_NAME} declares \"{kind}\" but the server "
                "never emits it"))
        return out
