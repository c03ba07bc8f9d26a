"""Import-layering checker: the port's declared layer graph.

Each rule maps a path pattern to import prefixes that source under it may
never import — not even lazily inside a function: a lazy ``import torch``
still drags the device runtime into the health plane the moment the code
path runs, which is exactly what the health plane's "debuggable while
training is wedged" contract forbids.

``layer-forbidden-import``
    An ``import X`` / ``from X import ...`` whose module matches a
    forbidden prefix for the file's layer.

Declared layers (LAYER_RULES; fnmatch patterns, whose ``*`` also crosses
``/``):
- ``telemetry.py`` and ``health/*`` are framework-free: no torch and none
  of the reference stack. They must be importable (and runnable) on a
  host with no accelerator stack, and must never trigger device
  initialization from a monitoring path.
- ``comms/*`` stays free of the reference stack only: torch is the port's
  array library, and its codecs quantize torch tensors.
- ``serving/*`` never imports ``trainers`` — inference hosts do not carry
  the training loop.
- ``models/*`` never imports ``parallel``/``trainers``/``serving`` —
  model definitions sit below every orchestration layer.
- every file of the package stays on its side of the port's boundary: no
  jax, flax, optax, orbax, ml_dtypes, nor anything of ``distkeras_tpu``
  (the port runs where the JAX stack is not installed).
"""

from __future__ import annotations

import ast
import fnmatch
from typing import List, Sequence, Tuple

from distkeras_tpu_torch.analysis.core import Checker, Finding, ModuleInfo

#: the JAX package and its stack: the port imports none of it
REFERENCE_STACK = ("jax", "flax", "optax", "orbax", "ml_dtypes",
                   "distkeras_tpu")

# (path glob, forbidden import prefixes, one-line rationale)
LAYER_RULES: Tuple[Tuple[str, Tuple[str, ...], str], ...] = (
    ("distkeras_tpu_torch/telemetry.py",
     ("torch",) + REFERENCE_STACK,
     "telemetry is step-path instrumentation and must stay importable "
     "without an accelerator stack"),
    ("distkeras_tpu_torch/health/*.py",
     ("torch",) + REFERENCE_STACK,
     "the health plane must work while the device runtime is wedged"),
    ("distkeras_tpu_torch/comms/*.py",
     REFERENCE_STACK,
     "wire codecs run on hosts without the reference stack (torch is "
     "the port's array library)"),
    ("distkeras_tpu_torch/serving/*.py",
     ("distkeras_tpu_torch.trainers",),
     "inference hosts do not carry the training loop"),
    ("distkeras_tpu_torch/models/*.py",
     ("distkeras_tpu_torch.parallel", "distkeras_tpu_torch.trainers",
      "distkeras_tpu_torch.serving"),
     "model definitions sit below every orchestration layer"),
    ("distkeras_tpu_torch/*.py",
     REFERENCE_STACK,
     "the port imports nothing of the JAX package or its stack: it runs "
     "where they are not installed"),
)


def _imported_modules(tree: ast.AST):
    """Yield (module_name, lineno, col) for every import, however deep
    (function-local lazy imports included — they still execute)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno, node.col_offset
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0:
                yield node.module, node.lineno, node.col_offset


def _matches(module: str, prefix: str) -> bool:
    return module == prefix or module.startswith(prefix + ".")


class LayeringChecker(Checker):
    name = "layering"
    rules = ("layer-forbidden-import",)

    def __init__(self, layer_rules: Sequence[Tuple[str, Tuple[str, ...],
                                                   str]] = LAYER_RULES):
        self.layer_rules = tuple(layer_rules)

    def check(self, modules: List[ModuleInfo]) -> List[Finding]:
        out: List[Finding] = []
        for mod in modules:
            if mod.tree is None:
                continue
            for pattern, forbidden, why in self.layer_rules:
                if not fnmatch.fnmatch(mod.relpath, pattern):
                    continue
                for name, line, col in _imported_modules(mod.tree):
                    for prefix in forbidden:
                        if _matches(name, prefix):
                            out.append(Finding(
                                "layer-forbidden-import", mod.relpath,
                                line, col,
                                f"`import {name}` violates the layer "
                                f"rule for {pattern} (forbids "
                                f"{prefix}): {why}"))
        return out
