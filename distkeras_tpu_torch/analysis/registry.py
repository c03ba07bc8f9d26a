"""Registry checkers for the port: telemetry-name consistency and
precision f32 pins.

Telemetry names are stringly-typed and cross ~15 producer modules, two
export consumers, the health endpoints, the root scripts and the tests; a
typo silently produces a parallel metric nobody reads. The single source
of truth is the port's ``telemetry.METRIC_NAMES`` / ``METRIC_PREFIXES``
(read here *from the AST*, so the lint suite never imports repo code):

``telemetry-undeclared-name``
    A producer call (``telemetry.counter/gauge/histogram("...")`` or
    ``span("...")``) whose literal name is not declared in the registry.
    Dynamic names (f-strings) must match a declared prefix family.
``telemetry-kind-mismatch``
    Producer uses a declared name with the wrong instrument kind
    (e.g. ``gauge("ps.commit.count")`` where the registry says counter).
``telemetry-unknown-consumer-name``
    A consumer module (profiling/health/scripts/tests) references a
    metric-shaped string in a declared namespace that no producer
    declares — the classic rename-producer-forget-consumer drift. Names
    the file itself fabricates (synthetic rows in tests) and fault-
    injection site ids are exempt.

``precision-f32-pin``
    The numerics contract (NUMERICS.md / precision.py): LayerNorm, final
    heads, and MoE routers compute in float32 under *every*
    PrecisionPolicy, and softmax inputs are never explicitly downcast.
    The port pins f32 its own way — float32 modules called on a float32
    input — so in models/ and ops/ it flags (a) an ``nn.LayerNorm``, or
    an ``nn.Linear``/``Dense`` bound to a ``self.*head*``/``*router*``
    attribute, built with a dtype other than float32; (b) a call of such
    an attribute whose input is not float32-rooted (``.float()`` or
    ``.to(torch.float32)`` in the argument's chain, or a pinned
    LayerNorm's output); (c) a softmax or log-softmax whose input holds an
    explicit downcast (``.to(torch.bfloat16)``, ``.to(torch.float16)``,
    ``.half()``, ``.bfloat16()``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_tpu_torch.analysis.core import (ROOT_SCRIPTS, Checker,
                                               Finding, ModuleInfo,
                                               dotted_name)

_TELEMETRY_MODULE = "distkeras_tpu_torch/telemetry.py"
_KIND_METHODS = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram", "span": "span"}
_METRIC_SHAPE = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")

# consumers scanned for dangling metric references (besides tests/): the
# port's counterparts of the JAX package's profiling and health consumers,
# and the root scripts (the JAX package's benchmarks/ consumers)
_CONSUMER_PATHS = (
    "distkeras_tpu_torch/profiling/cost_model.py",
    "distkeras_tpu_torch/profiling/roofline.py",
    "distkeras_tpu_torch/profiling/capture.py",
    "distkeras_tpu_torch/health/export.py",
    "distkeras_tpu_torch/health/endpoints.py",
    "distkeras_tpu_torch/health/slo.py",
    "distkeras_tpu_torch/health/recorder.py",
    "distkeras_tpu_torch/health/cli.py",
    "distkeras_tpu_torch/health/timeseries.py",
) + ROOT_SCRIPTS
_FAULT_FUNCS = {"inject", "apply", "clear_injections",
                "inject_chaos", "chaos", "clear_chaos"}


def _literal_dict(tree: ast.AST, name: str) -> Dict[str, str]:
    """Module-level ``NAME = {"k": "v", ...}`` literal, else empty."""
    for node in ast.iter_child_nodes(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == name
                   for t in node.targets):
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        out: Dict[str, str] = {}
        for k, v in zip(node.value.keys, node.value.values):
            if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                out[k.value] = v.value
        return out
    return {}


def load_declared_names(modules: Sequence[ModuleInfo],
                        ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(METRIC_NAMES, METRIC_PREFIXES) parsed from telemetry.py's AST."""
    for mod in modules:
        if mod.relpath == _TELEMETRY_MODULE and mod.tree is not None:
            return (_literal_dict(mod.tree, "METRIC_NAMES"),
                    _literal_dict(mod.tree, "METRIC_PREFIXES"))
    return {}, {}


def _fstring_prefix(node: ast.JoinedStr) -> str:
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            break
    return "".join(parts)


def _producer_calls(mod: ModuleInfo):
    """Yield (kind, name_node, call) for telemetry producer calls."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        target = dotted_name(node.func)
        if target is None:
            continue
        head, _, meth = target.rpartition(".")
        if not head:
            head, meth = "", target
        if meth not in _KIND_METHODS:
            continue
        # telemetry.counter(...) / bare span(...) imported from telemetry
        if head.rsplit(".", 1)[-1] != "telemetry" and not (
                head == "" and meth == "span"):
            continue
        yield _KIND_METHODS[meth], node.args[0], node


def _fault_sites(modules: Sequence[ModuleInfo]) -> Set[str]:
    sites: Set[str] = set()
    for mod in modules:
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            target = dotted_name(node.func)
            if target is None:
                continue
            if target.rsplit(".", 1)[-1] in _FAULT_FUNCS:
                a = node.args[0]
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    sites.add(a.value)
    return sites


class TelemetryRegistryChecker(Checker):
    name = "telemetry-registry"
    rules = ("telemetry-undeclared-name", "telemetry-kind-mismatch",
             "telemetry-unknown-consumer-name")

    PRODUCER_SCOPE = ("distkeras_tpu_torch/",)

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        if not any(m.relpath == _TELEMETRY_MODULE for m in modules):
            return []  # tree without a telemetry module: nothing to check
        declared, prefixes = load_declared_names(modules)
        out: List[Finding] = []
        if not declared:
            out.append(Finding(
                "telemetry-undeclared-name", _TELEMETRY_MODULE, 1, 0,
                "METRIC_NAMES literal dict not found in telemetry.py — "
                "the registry is the single source of metric names"))
            return out
        fault_sites = _fault_sites(modules)
        namespaces = {n.split(".", 1)[0] for n in declared}
        namespaces |= {p.split(".", 1)[0] for p in prefixes}

        for mod in modules:
            if mod.tree is None:
                continue
            if ((mod.relpath.startswith(self.PRODUCER_SCOPE)
                 or mod.relpath in ROOT_SCRIPTS)
                    and mod.relpath != _TELEMETRY_MODULE):
                out.extend(self._check_producers(mod, declared, prefixes))
            if (mod.relpath in _CONSUMER_PATHS
                    or mod.relpath.startswith("tests/")):
                out.extend(self._check_consumers(
                    mod, declared, prefixes, namespaces, fault_sites))
        return out

    def _check_producers(self, mod: ModuleInfo, declared: Dict[str, str],
                         prefixes: Dict[str, str]) -> List[Finding]:
        out: List[Finding] = []
        for kind, name_node, call in _producer_calls(mod):
            loc = (call.lineno, call.col_offset)
            if isinstance(name_node, ast.Constant) and isinstance(
                    name_node.value, str):
                name = name_node.value
                if name in declared:
                    want = declared[name]
                    if want != kind:
                        out.append(Finding(
                            "telemetry-kind-mismatch", mod.relpath, *loc,
                            f"\"{name}\" is declared as a {want} but "
                            f"produced as a {kind}"))
                elif not any(name.startswith(p) for p in prefixes):
                    out.append(Finding(
                        "telemetry-undeclared-name", mod.relpath, *loc,
                        f"metric \"{name}\" is not declared in "
                        "telemetry.METRIC_NAMES — declare it once there"))
            elif isinstance(name_node, ast.JoinedStr):
                literal = _fstring_prefix(name_node)
                if not any(literal.startswith(p) or p.startswith(literal)
                           for p in prefixes):
                    out.append(Finding(
                        "telemetry-undeclared-name", mod.relpath, *loc,
                        f"dynamic metric name (f-string prefix "
                        f"\"{literal}\") matches no declared prefix "
                        "family in telemetry.METRIC_PREFIXES"))
        return out

    def _check_consumers(self, mod: ModuleInfo, declared: Dict[str, str],
                         prefixes: Dict[str, str], namespaces: Set[str],
                         fault_sites: Set[str]) -> List[Finding]:
        local: Set[str] = set()
        for kind, name_node, _ in _producer_calls(mod):
            if isinstance(name_node, ast.Constant) and isinstance(
                    name_node.value, str):
                local.add(name_node.value)
        # synthetic rows ({"name": "..."} dict literals) are file-local
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant)
                            and k.value in ("name", "site")
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)):
                        local.add(v.value)

        out: List[Finding] = []
        seen: Set[str] = set()
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            s = node.value
            if s in seen or not _METRIC_SHAPE.fullmatch(s):
                continue
            # dotted-path artifacts, not metric names
            if s.endswith((".json", ".jsonl", ".log", ".txt", ".csv",
                           ".md", ".py", ".cc", ".prom")):
                continue
            if s.split(".", 1)[0] not in namespaces:
                continue
            if (s in declared or s in local or s in fault_sites
                    or any(s.startswith(p) for p in prefixes)):
                seen.add(s)
                continue
            # prefix-style reference: "health.worker." or a strict prefix
            # of a declared name used with startswith()
            if any(d.startswith(s) for d in declared):
                seen.add(s)
                continue
            seen.add(s)
            out.append(Finding(
                "telemetry-unknown-consumer-name", mod.relpath,
                node.lineno, node.col_offset,
                f"consumer references metric \"{s}\" which no producer "
                "declares in telemetry.METRIC_NAMES — renamed producer or "
                "typo'd consumer"))
        return out


# ---------------------------------------------------------------------------
# precision pinning

#: constructor base name -> (its dtype keyword, that argument's position)
_DTYPE_ARG = {"LayerNorm": ("dtype", 5), "Linear": ("dtype", 4),
              # transformer.Dense(in, out, compute_dtype, precision)
              "Dense": ("compute_dtype", 2)}
#: receivers of the function forms of softmax (else ``x.softmax(...)``)
_SOFTMAX_MODULES = {"torch", "F", "functional", "nn.functional",
                    "torch.nn.functional", "torch.special"}
_DOWNCAST_METHODS = ("half", "bfloat16")


def _dtype_arg(call: ast.Call, base: str) -> Optional[ast.expr]:
    kw, pos = _DTYPE_ARG[base]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _dtype_is(node: Optional[ast.expr], names: Sequence[str]) -> bool:
    name = dotted_name(node) if node is not None else None
    return bool(name) and name.rsplit(".", 1)[-1] in names


def _is_f32(node: Optional[ast.expr]) -> bool:
    if node is None:
        return False
    return _dtype_is(node, ("float32",)) or dotted_name(node) == "torch.float"


def _to_target(call: ast.Call) -> Optional[ast.expr]:
    """The dtype of ``t.to(dtype)`` / ``t.to(dtype=...)``, else None."""
    for k in call.keywords:
        if k.arg == "dtype":
            return k.value
    return call.args[0] if call.args else None


def _is_downcast(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in _DOWNCAST_METHODS and not node.args:
        return True
    return attr == "to" and _dtype_is(_to_target(node),
                                      ("bfloat16", "float16", "half"))


def _self_attr(node: ast.expr) -> Optional[str]:
    """``self.name`` -> "name", else None."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _f32_rooted(node: ast.expr, pinned_norms: Set[str]) -> bool:
    """True when the argument's chain (its receivers, through calls,
    attributes and subscripts) holds ``.float()`` or
    ``.to(torch.float32)``, or is the output of a pinned LayerNorm."""
    while True:
        if isinstance(node, ast.Call):
            func = node.func
            if not isinstance(func, ast.Attribute):
                return False
            if func.attr == "float" and not node.args:
                return True
            if func.attr == "to" and _is_f32(_to_target(node)):
                return True
            if _self_attr(func) in pinned_norms:
                return True
            node = func.value
        elif isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        else:
            return False


def _class_nodes(cls: ast.ClassDef):
    """Every node of a class body, its methods included, not descending
    into nested classes (checked as classes of their own)."""
    stack = list(ast.iter_child_nodes(cls))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, ast.ClassDef):
            stack.extend(ast.iter_child_nodes(node))


class PrecisionPinChecker(Checker):
    name = "precision"
    rules = ("precision-f32-pin",)

    SCOPE = ("distkeras_tpu_torch/models/", "distkeras_tpu_torch/ops/")
    PINNED_DENSE_NAMES = ("head", "router")

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        out: List[Finding] = []
        for mod in modules:
            if mod.tree is None or not mod.relpath.startswith(self.SCOPE):
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    out.extend(self._check_class(mod, node))
                elif isinstance(node, ast.Call):
                    out.extend(self._check_layernorm(mod, node))
                    out.extend(self._check_softmax(mod, node))
        return out

    def _check_layernorm(self, mod: ModuleInfo,
                         call: ast.Call) -> List[Finding]:
        """(a) for every LayerNorm, bound to an attribute or not."""
        target = dotted_name(call.func)
        if not target or target.rsplit(".", 1)[-1] != "LayerNorm":
            return []
        dtype = _dtype_arg(call, "LayerNorm")
        if dtype is None or _is_f32(dtype):
            return []
        return [Finding(
            "precision-f32-pin", mod.relpath, call.lineno, call.col_offset,
            "LayerNorm is built with a dtype other than torch.float32: "
            "the numerics contract keeps normalization statistics in f32 "
            "under every PrecisionPolicy")]

    def _check_class(self, mod: ModuleInfo,
                     cls: ast.ClassDef) -> List[Finding]:
        """(a) for the head/router Linears bound to ``self.*``, and (b)
        for every call of a pinned attribute of the class."""
        out: List[Finding] = []
        pinned: Dict[str, str] = {}  # attr -> "LayerNorm" | "head/router"
        for node in _class_nodes(cls):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            target = dotted_name(node.value.func)
            base = target.rsplit(".", 1)[-1] if target else None
            if base not in _DTYPE_ARG:
                continue
            dtype = _dtype_arg(node.value, base)
            f32 = dtype is None or _is_f32(dtype)
            for t in node.targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if base == "LayerNorm":
                    if f32:  # else (a) already flagged the call
                        pinned[attr] = "LayerNorm"
                elif any(p in attr for p in self.PINNED_DENSE_NAMES):
                    if f32:
                        pinned[attr] = "head/router"
                    else:
                        out.append(Finding(
                            "precision-f32-pin", mod.relpath,
                            node.value.lineno, node.value.col_offset,
                            f"{base} `self.{attr}` is a head/router op "
                            "built with a dtype other than torch.float32: "
                            "it must keep f32 under every "
                            "PrecisionPolicy"))
        norms = {a for a, what in pinned.items() if what == "LayerNorm"}
        for node in _class_nodes(cls):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            attr = _self_attr(node.func)
            if attr not in pinned or _f32_rooted(node.args[0], norms):
                continue
            out.append(Finding(
                "precision-f32-pin", mod.relpath, node.lineno,
                node.col_offset,
                f"`self.{attr}` is an f32-pinned {pinned[attr]} called on "
                "an input that is not float32-rooted — pass `x.float()` "
                "(or `.to(torch.float32)`, or a pinned LayerNorm's "
                "output), as the port's numerics contract does"))
        return out

    def _check_softmax(self, mod: ModuleInfo,
                       call: ast.Call) -> List[Finding]:
        """(c): no explicit downcast inside a softmax's input."""
        func = call.func
        if isinstance(func, ast.Attribute):
            base = func.attr
            method = dotted_name(func.value) not in _SOFTMAX_MODULES
        elif isinstance(func, ast.Name):
            base, method = func.id, False
        else:
            return []
        if base not in ("softmax", "log_softmax"):
            return []
        inputs = [func.value] if method else call.args[:1]
        return [Finding(
            "precision-f32-pin", mod.relpath, sub.lineno, sub.col_offset,
            "softmax input is explicitly downcast — attention/router "
            "softmax must compute in f32 (cast the *output* back "
            "instead)")
            for arg in inputs for sub in ast.walk(arg) if _is_downcast(sub)]
