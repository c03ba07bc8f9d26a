"""Time this checkout's serving path against another checkout's on one card.

    python3 serving_ab.py --other OLD

``OLD`` is an unpacked earlier commit of this repo (``git archive``). Each
checkout's paged ``GenerationEngine`` (gpt_small in bf16, page_size 16,
chip_smoke's ``ENGINE_KW``) runs, in its own process, the same traffic,
that of this checkout's ``chip_smoke.py``: phase 4's windows (128
requests of 16-128 prompt tokens and 64 new tokens each, 8 in flight,
three times over: tokens/s, TTFT, the longest emission gap and the
garbage collector's time a window, the paged kernel's launches against
the model calls) and then phase 6's traced run (the device's busy share
and kernels a model call), in the order other, this, this, other. Prints
one JSON line of the four runs and writes ``serving_ab.json`` into
``chip_smoke.OUT_DIR``. Exits 1 unless every run passed its checks.
Needs a CUDA card and nvcc; each checkout builds its own paged kernel.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import ab_driver
import chip_smoke

#: what each run reports of a window, and of the traced run
WINDOW_KEYS = ("tokens_per_s", "wall_s", "ttft_p50_s", "ttft_max_s",
               "ms_per_call", "max_gap_ms", "max_gap_at_s", "gc_s")
PROFILE_KEYS = ("wall_s", "device_busy_s", "device_busy_share",
                "kernels_per_call", "paged_kernels_per_call")


def run_tree(tree, args) -> dict:
    """Phase 4's windows and phase 6's traced run, driven by this
    checkout's ``chip_smoke`` through the engine of the checkout at
    ``tree``."""
    ab_driver.use_tree(tree)
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import GenerationEngine

    fa._kernel_lib()
    dev = torch.device("cuda:0")
    card = chip_smoke.phase_device()["nvidia_smi"]
    model = chip_smoke._gpt_small_bf16()
    chip_smoke.set_tf32(False)
    t0 = time.perf_counter()
    with GenerationEngine(model, device=dev, page_size=chip_smoke.PAGE,
                          **chip_smoke.ENGINE_KW) as eng:
        setup_s = time.perf_counter() - t0
        engine = chip_smoke._serve_windows(eng)
        profile = chip_smoke._traced_serve(eng, "profile")
    assert engine["launches"] == model.num_layers * engine["model_calls"]
    assert profile["paged_kernels_traced"] == (
        2 * profile["paged_calls_counted"]) > 0, profile
    return {"setup_s": setup_s, "launches": engine["launches"],
            "model_calls": engine["model_calls"],
            "windows": [{k: w[k] for k in WINDOW_KEYS}
                        for w in engine["windows"]],
            "profile": {k: profile[k] for k in PROFILE_KEYS},
            "card": card}


def report(runs, args) -> tuple:
    """One row: each key a list over the runs (other, this, this, other),
    a window's key a list over that run's windows."""
    row = {"order": list(ab_driver.ORDER),
           **{f"window.{k}": [run and [w[k] for w in run["windows"]]
                              for run in runs] for k in WINDOW_KEYS},
           **{f"profile.{k}": [run and run["profile"][k] for run in runs]
              for k in PROFILE_KEYS},
           **{k: [run and run[k] for run in runs]
              for k in ("setup_s", "launches", "model_calls", "card")}}
    print(json.dumps(row), flush=True)
    return True, {"row": row, "runs": runs}


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, run_tree, report))
