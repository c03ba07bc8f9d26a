"""Lock-and-thread discipline checker for the port.

The port runs the JAX package's background threads (batcher, generation
scheduler, comms-overlap double buffers, heartbeats, watchdog, socket
servers), so two classes of bug matter:

``lock-blocking-call``
    A blocking operation — socket send/recv/accept/connect, the framing
    helpers ``send_message``/``recv_message`` and their chunked halves
    ``send_buffers``/``_recvexact`` (the JAX package's ``_sendall``/
    ``_recv`` names are kept), ``queue.get``/``put`` on a known queue,
    ``Future.result``, ``Thread.join``, ``time.sleep``, a checkpointer's
    ``wait()`` (Orbax ``wait_until_finished`` in the JAX package) —
    executed while a ``threading`` lock is held. Held locks are tracked
    lexically through ``with`` blocks; ``cv.wait()``/``wait_for()`` on the
    condition variable being held is exempt (wait *releases* the lock).

``lock-order-cycle``
    Inconsistent acquisition order between two locks. Edges come from
    lexically nested ``with`` blocks plus one hop of same-class call
    resolution (method acquiring lock B called under lock A); a cycle in
    the global graph across the port's serving/, parallel/, health/ and
    checkpoint.py is a deadlock waiting for the right interleaving.

Lock discovery: attributes assigned ``threading.Lock()`` / ``RLock()`` /
``Condition()`` (module-level names too), plus a defensive name heuristic
(``*_lock`` / ``*_cv`` / ``*_cond`` / ``*_mutex``). Queues are attributes
assigned ``queue.Queue(...)`` / ``SimpleQueue()`` / ``LifoQueue()``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from distkeras_tpu_torch.analysis.core import (Checker, Finding,
                                               ModuleInfo, dotted_name)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition"}
_QUEUE_CTORS = {"queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue", "Queue", "SimpleQueue",
                "queue_lib.Queue", "queue_lib.SimpleQueue"}
_LOCKISH_NAME = re.compile(r".*(_lock|_cv|_cond|_mutex|_mu)$|^lock$|^cv$")

# the JAX package's framing names, and the port's names for the same
# calls: comms/chunking.py's chunked socket send and remote_ps.py's exact
# read
_BLOCKING_HELPERS = {"send_message", "recv_message", "_sendall", "_recv",
                     "_recv_exact", "recv_exact", "send_buffers",
                     "_recvexact"}
_BLOCKING_DOTTED = {"socket.create_connection", "time.sleep"}
_BLOCKING_METHODS = {"sendall", "recv", "accept", "connect",
                     "result", "wait_until_finished"}
_CV_METHODS = {"wait", "wait_for", "notify", "notify_all"}


def _recv_key(node: ast.expr, cls: Optional[str], modname: str,
              ) -> Optional[str]:
    """Canonical key for a lock/queue-bearing expression: ``self._lock``
    inside class C -> "C.self._lock"; bare module name -> "mod:<name>"."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id == "self" and cls:
            return f"{modname}:{cls}.self.{node.attr}"
        return None
    if isinstance(node, ast.Name):
        return f"{modname}:{node.id}"
    return None


class _ClassMap:
    """Per-module discovery: lock/queue attribute keys + class of each
    function node."""

    def __init__(self, mod: ModuleInfo) -> None:
        self.locks: Set[str] = set()
        self.queues: Set[str] = set()
        self.cls_of_fn: Dict[int, Optional[str]] = {}
        self.methods: Dict[Tuple[str, str], ast.AST] = {}
        self.modname = mod.relpath
        self._walk(mod.tree, None)

    def _walk(self, node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._walk(child, child.name)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.cls_of_fn[id(child)] = cls
                if cls:
                    self.methods[(cls, child.name)] = child
            if isinstance(child, ast.Assign) and isinstance(child.value,
                                                            ast.Call):
                ctor = dotted_name(child.value.func)
                for t in child.targets:
                    key = _recv_key(t, cls, self.modname)
                    if key is None:
                        continue
                    if ctor in _LOCK_CTORS:
                        self.locks.add(key)
                    elif ctor in _QUEUE_CTORS:
                        self.queues.add(key)
            self._walk(child, cls)

    def lock_key(self, expr: ast.expr, cls: Optional[str]) -> Optional[str]:
        key = _recv_key(expr, cls, self.modname)
        if key is None:
            return None
        if key in self.locks:
            return key
        attr = key.rsplit(".", 1)[-1].rsplit(":", 1)[-1]
        if _LOCKISH_NAME.match(attr):
            return key
        return None


class LockDisciplineChecker(Checker):
    name = "locks"
    rules = ("lock-blocking-call", "lock-order-cycle")

    SCOPE = ("distkeras_tpu_torch/",)

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        out: List[Finding] = []
        # global order graph: (lockA, lockB) -> location of first evidence
        edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        for mod in modules:
            if mod.tree is None or not mod.relpath.startswith(self.SCOPE):
                continue
            self._scan_module(mod, _ClassMap(mod), out, edges)
        out.extend(self._find_cycles(edges))
        return out

    # ------------------------------------------------------------------
    def _scan_module(self, mod: ModuleInfo, cmap: _ClassMap,
                     out: List[Finding],
                     edges: Dict[Tuple[str, str], Tuple[str, int]]) -> None:
        # top-level locks acquired by each method (for one-hop call edges)
        first_locks: Dict[Tuple[str, str], Set[str]] = {}
        for (cls, name), fn in cmap.methods.items():
            first_locks[(cls, name)] = self._acquired_anywhere(fn, cls, cmap)

        def visit_child(node: ast.AST, cls: Optional[str],
                        held: List[str]) -> None:
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    visit_child(child, node.name, held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # a nested def's body does not run under the enclosing lock
                body = node.body if isinstance(node.body, list) else [
                    node.body]
                for child in body:
                    visit_child(child, cls, [])
                return
            if isinstance(node, ast.With):
                acquired = []
                for item in node.items:
                    key = cmap.lock_key(item.context_expr, cls)
                    if key is not None:
                        for h in held + acquired:
                            if h != key:
                                edges.setdefault((h, key),
                                                 (mod.relpath, node.lineno))
                        acquired.append(key)
                # context expressions themselves evaluated with prior holds
                for item in node.items:
                    visit_child(item.context_expr, cls, held)
                for inner in node.body:
                    visit_child(inner, cls, held + acquired)
                return
            if isinstance(node, ast.Call) and held:
                self._check_blocking(mod, node, cls, held, cmap, out)
                self._call_edges(node, cls, held, first_locks, cmap,
                                 edges, mod)
            for child in ast.iter_child_nodes(node):
                visit_child(child, cls, held)

        visit_child(mod.tree, None, [])

    # ------------------------------------------------------------------
    def _acquired_anywhere(self, fn: ast.AST, cls: Optional[str],
                           cmap: _ClassMap) -> Set[str]:
        keys: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    key = cmap.lock_key(item.context_expr, cls)
                    if key is not None:
                        keys.add(key)
        return keys

    def _call_edges(self, call: ast.Call, cls: Optional[str],
                    held: Sequence[str],
                    first_locks: Dict[Tuple[str, str], Set[str]],
                    cmap: _ClassMap,
                    edges: Dict[Tuple[str, str], Tuple[str, int]],
                    mod: ModuleInfo) -> None:
        """One-hop: `self.m()` under lock A where m acquires lock B."""
        if not (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self" and cls):
            return
        for key in first_locks.get((cls, call.func.attr), ()):
            for h in held:
                if h != key:
                    edges.setdefault((h, key), (mod.relpath, call.lineno))

    # ------------------------------------------------------------------
    def _check_blocking(self, mod: ModuleInfo, call: ast.Call,
                        cls: Optional[str], held: Sequence[str],
                        cmap: _ClassMap, out: List[Finding]) -> None:
        target = dotted_name(call.func)
        line, col = call.lineno, call.col_offset
        held_desc = ", ".join(sorted(set(held)))

        def flag(what: str) -> None:
            out.append(Finding(
                "lock-blocking-call", mod.relpath, line, col,
                f"{what} while holding {held_desc} — blocks every other "
                "thread contending on the lock for the full I/O wait"))

        if target in _BLOCKING_DOTTED:
            flag(f"blocking call `{target}`")
            return
        if target in _BLOCKING_HELPERS:
            flag(f"socket framing helper `{target}`")
            return
        if not isinstance(call.func, ast.Attribute):
            return
        meth = call.func.attr
        recv_key = _recv_key(call.func.value, cls, cmap.modname)

        if meth in _CV_METHODS:
            # waiting on the held condition variable RELEASES it: fine.
            # waiting on anything else (an Event, another cv) blocks.
            if meth in ("wait", "wait_for") and recv_key not in held:
                flag(f"`.{meth}()` on an object other than the held lock")
            return
        if meth in ("get", "put"):
            if recv_key is not None and recv_key in cmap.queues:
                flag(f"queue `.{meth}()`")
            return
        if meth == "join":
            # exclude the str.join idiom: one positional argument
            if len(call.args) == 0 or (len(call.args) == 1
                                       and not call.keywords
                                       and isinstance(call.args[0],
                                                      ast.Constant)):
                if not isinstance(call.func.value, ast.Constant):
                    flag("thread `.join()`")
            return
        if meth in _BLOCKING_METHODS:
            flag(f"blocking `.{meth}()`")

    # ------------------------------------------------------------------
    def _find_cycles(self, edges: Dict[Tuple[str, str], Tuple[str, int]],
                     ) -> List[Finding]:
        graph: Dict[str, Set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
        out: List[Finding] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(start: str, node: str, path: List[str],
                visited: Set[str]) -> None:
            for nxt in graph.get(node, ()):
                if nxt == start and len(path) >= 2:
                    cyc = tuple(sorted(path))
                    if cyc not in seen_cycles:
                        seen_cycles.add(cyc)
                        relpath, line = edges[(path[-1], start)]
                        out.append(Finding(
                            "lock-order-cycle", relpath, line, 0,
                            "lock-order cycle: " + " -> ".join(
                                path + [start]) + " — acquisition order "
                            "must be globally consistent"))
                elif nxt not in visited:
                    visited.add(nxt)
                    dfs(start, nxt, path + [nxt], visited)

        for start in sorted(graph):
            dfs(start, start, [start], {start})
        return out
