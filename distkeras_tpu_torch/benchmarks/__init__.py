"""Benchmark harness for the five BASELINE.md configs on the port.

Run with ``python -m distkeras_tpu_torch.benchmarks <1-5|all> [--full]``.
"""

from distkeras_tpu_torch.benchmarks.run_config import CONFIGS, main

__all__ = ["CONFIGS", "main"]
