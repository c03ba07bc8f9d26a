"""dktlint for the port — the static-analysis suite over
``distkeras_tpu_torch/``, its tests and its root scripts.

Run it with ``python -m distkeras_tpu_torch.analysis``; the pytest gate
(tests/test_torch_lint_clean.py) self-hosts it on the repo in tier-1.
Checkers:

- locks: blocking calls under a held threading lock, lock-order cycles;
- wire: client/server op-string and error-taxonomy drift across the four
  socket protocols (the port's dispatch tables included);
- telemetry-registry: producers/consumers vs telemetry.METRIC_NAMES;
- precision: f32 pins on LayerNorm / heads / routers (float32 modules
  called on float32-rooted inputs) and softmax inputs;
- layering: the declared import-layer graph (health and telemetry are
  framework-free, comms and the whole package stay clear of the JAX
  stack, serving never imports trainers, models sit below parallel).

The JAX suite's jit-purity checker has no counterpart: the port hands no
function to a tracer (``--list-rules`` says why).

Everything is stdlib-``ast`` based: the suite reads repo *source* and
never imports repo modules, so it runs on hosts without torch or jax.
"""

from distkeras_tpu_torch.analysis.core import (Checker, Finding,
                                               ModuleInfo, Report,
                                               collect_modules,
                                               default_checkers, run_suite)

__all__ = ["Checker", "Finding", "ModuleInfo", "Report",
           "collect_modules", "default_checkers", "run_suite"]
