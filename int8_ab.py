"""Time this checkout's int8 product against another checkout's on one card.

    python3 int8_ab.py --other OLD

``OLD`` is an unpacked earlier commit of this repo (``git archive``). Each
checkout runs, in its own process and through its own ``chip_smoke.py``,
phase 11 (the int8 kernel bitwise against its plain version at the four
GPT-2-small products, with its device ms a call, the plain version's,
``torch._int_mm`` plus the scale and the bound) and phase 12 (the int8
train path: 1 warm-up and 4 timed steps, 48 int8 launches a step) with
its traced step, in the order other, this, this, other. Prints one JSON
line a product and one for the train step, and writes ``int8_ab.json``
into ``chip_smoke.OUT_DIR``. Exits 1 unless every run passed its phases.
Needs a CUDA card and nvcc; each checkout builds its own kernels on first
use.
"""

from __future__ import annotations

import json
import sys

import torch

import ab_driver
import chip_smoke


def run_tree(tree, args) -> dict:
    """Phases 11 and 12 (and the traced step) of the checkout at
    ``tree``, through its own ``chip_smoke``."""
    ab_driver.use_tree(tree)
    import chip_smoke as smoke
    from concurrent.futures import ThreadPoolExecutor

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    with ThreadPoolExecutor(3) as pool:  # one nvcc a library, at once
        for fut in [pool.submit(f) for f in (
                i8._kernel_lib, lambda: fa._flash_lib("fwd"),
                lambda: fa._flash_lib("bwd"))]:
            fut.result()
    dev = torch.device("cuda:0")
    card = smoke.phase_device()["nvidia_smi"]
    cases = smoke.phase_int8_kernel(dev)
    train, run = smoke.phase_int8_train(dev, card)
    profile = smoke.phase_train_profile(*run, tag="int8-profile")
    int8 = [k for k in profile["top_kernels"] if "int8_matmul" in k["name"]]
    return {"cases": cases, "median_step_s": train["median_step_s"],
            "step_s": train["step_s"], "launches": train["launches"],
            "traced_wall_s": profile["wall_s"],
            "traced_busy_s": profile["device_busy_s"],
            "traced_int8_ms": sum(k["device_ms"] for k in int8),
            "traced_int8_launches": sum(k["count"] for k in int8),
            "card": card}


def report(runs, args) -> tuple:
    """One row a product and one for the train step."""
    rows = []
    for i, (name, k, n) in enumerate(chip_smoke.INT8_CASES):
        got = [run["cases"][i] if run else {} for run in runs]
        row = {"name": name, "m": chip_smoke.INT8_M, "k": k, "n": n,
               "other_this_this_other_ms": [g.get("ms") for g in got],
               "library_ms": [g.get("library_ms") for g in got],
               "this_plan": got[1].get("plan"),
               **chip_smoke._int8_bound(chip_smoke.INT8_M, k, n,
                                        torch.bfloat16)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    step = {"name": "int8 train step",
            "other_this_this_other_median_ms": [
                run and run["median_step_s"] * 1e3 for run in runs],
            "traced_int8_ms": [run and run["traced_int8_ms"] for run in runs],
            "traced_int8_launches": [run and run["traced_int8_launches"]
                                     for run in runs],
            "traced_busy_ms": [run and run["traced_busy_s"] * 1e3
                               for run in runs],
            "traced_wall_ms": [run and run["traced_wall_s"] * 1e3
                               for run in runs],
            "card": [run and run["card"] for run in runs]}
    rows.append(step)
    print(json.dumps(step), flush=True)
    return True, {"rows": rows, "runs": runs}


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, run_tree, report))
