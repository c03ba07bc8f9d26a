"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero and prints no result):

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — nvcc builds every kernel of the serving path from the
   sources in this checkout (sm_90a) into the git-ignored build directory;
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes gpt_small serving gives it (float32 with TF32 off, and
   bf16), with its time, the plain version's time, one PyTorch library
   call's time for the same function, and its bound from this run's data;
4. engine  — the main path: GenerationEngine(gpt_small) in bf16 on the
   card with seeded random weights, paged (page_size 16), 8 slots,
   prefill buckets (32, 128), 8 concurrent requests of 32 new tokens;
   the kernels' launch counts are zeroed just before and read just after;
5. greedy  — in float32 with TF32 off, the engine's greedy tokens for two
   prompts equal the argmax of the port's full forward (plain attention,
   no kernel) re-run over each growing prefix;
6. profile — a separate short run of the main path under torch.profiler:
   the device's busy share and its time by kernel.

The last three lines of standard output are the kernels' JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details are
also written to ``chiprun_out/chip_smoke.json``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FLOP/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# gpt_small paged serving geometry (the engine phase uses the same)
H, D, PAGE, PMAX, SLOTS = 12, 64, 16, 64, 8
NUM_PAGES = SLOTS * PMAX        # + 1 scratch page
BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def log(*args):
    print(*args, flush=True)


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds a call over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device milliseconds a call (the sum of its CUDA kernels'
    times, from torch.profiler), or None when the profiler records no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


# -- phase 1 -----------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "nvidia_smi": smi_line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"[device] {json.dumps(info)}")
    assert info["capability"][0] >= 9, "the kernels are built for sm_90a"
    return info


# -- phase 2 -----------------------------------------------------------------

def phase_build() -> dict:
    from distkeras_tpu_torch.ops.kernels import _build
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    t0 = time.perf_counter()
    fa._kernel_lib()
    wall = time.perf_counter() - t0
    info = dict(_build.build_info["paged_attention"], wall_s=wall)
    log(f"[build] paged_attention in {wall:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")
    return info


# -- phase 3 -----------------------------------------------------------------

def _paged_inputs(b, t, dtype, rng, dev):
    """q, k_pages, v_pages, page_table, cache_index at the engine's pool
    geometry: tables drawn from every page INCLUDING the scratch page,
    cursors random with room for the block."""
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(b, t, H, D)
    k = mk(NUM_PAGES + 1, PAGE, H, D)
    v = mk(NUM_PAGES + 1, PAGE, H, D)
    table = rng.permutation(NUM_PAGES + 1)[:b * PMAX].reshape(b, PMAX)
    ci = rng.integers(0, PMAX * PAGE - t + 1, size=b)
    return (q, k, v, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(ci.astype(np.int32)).to(dev))


def _bound(b, t, dtype, ci):
    """Least time for this call on this data: each visible K/V cell, q,
    out, the table and the cursors moved once; 4*d flops per visible
    (query, key) pair at the operand type's peak. Also the bytes of the
    full fixed-length contraction (every table slot), for reference."""
    item = torch.finfo(dtype).bits // 8
    max_len = PMAX * PAGE
    keys = [min(max_len, int(c) + t) for c in ci]
    pairs = sum(min(max_len, int(c) + i + 1) for c in ci for i in range(t))
    kv_bytes = 2 * sum(keys) * H * D * item
    io_bytes = 2 * b * t * H * D * item + b * PMAX * 4 + b * 4
    flops = 4 * D * H * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    full_bytes = 2 * b * PMAX * PAGE * H * D * item + io_bytes
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": kv_bytes + io_bytes, "flops": flops,
            "bound_full_pool_ms": full_bytes / HBM_BYTES_PER_S * 1e3}


def phase_kernels(dev) -> list:
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        set_tf32(False)
        for b, t in ((1, 2), (8, 2), (1, 128)):
            q, k, v, table, ci = _paged_inputs(b, t, dtype, rng, dev)
            args = (q, k, v, table, ci)
            got = fa.paged_flash_attention(*args)
            want = fa.paged_flash_attention_reference(*args)
            torch.cuda.synchronize()
            assert got.shape == want.shape == q.shape
            assert torch.isfinite(got).all()
            err = (got.float() - want.float()).abs().max().item()
            # rotate over copies of the pool so timed calls find K/V
            # outside the 50 MB L2, as a 12-layer decode step does
            copies = max(1, math.ceil(120e6 / (2 * k.numel() * k.element_size())))
            pools = [(k, v)] + [(k.clone(), v.clone())
                                for _ in range(copies - 1)]
            pick = lambda i: pools[i % len(pools)]
            kernel = lambda i: fa.paged_flash_attention(q, *pick(i), table,
                                                        ci)
            plain = lambda i: fa.paged_flash_attention_reference(
                q, *pick(i), table, ci)
            # the library yardstick: SDPA over the dense gather, same mask
            max_len = PMAX * PAGE
            dense = [(kk[table.long()].reshape(b, max_len, H, D).transpose(1, 2),
                      vv[table.long()].reshape(b, max_len, H, D).transpose(1, 2))
                     for kk, vv in pools]
            pos = ci.long()[:, None] + torch.arange(t, device=dev)[None, :]
            mask = (torch.arange(max_len, device=dev)[None, None, None, :]
                    <= pos[:, None, :, None])
            qt = q.transpose(1, 2)
            lib_out = F.scaled_dot_product_attention(qt, *dense[0],
                                                     attn_mask=mask)
            lib_err = (lib_out.transpose(1, 2).float()
                       - want.float()).abs().max().item()
            library = lambda i: F.scaled_dot_product_attention(
                qt, *dense[i % len(dense)], attn_mask=mask)
            # device time (profiler) where it is recorded, else the
            # events time of back-to-back calls, which includes the host
            times = {}
            for name, fn in (("ms", kernel), ("plain_ms", plain),
                             ("library_ms", library)):
                call = cuda_ms(fn)
                dev_ms = device_ms(fn)
                times[name] = call if dev_ms is None else dev_ms
                times[name.replace("ms", "call_ms")] = call
                times[name.replace("ms", "ms_source")] = (
                    "events" if dev_ms is None else "profiler")
            ms, plain_ms, library_ms = (times["ms"], times["plain_ms"],
                                        times["library_ms"])
            del dense, pools
            case = {"b": b, "t": t, "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": err, "bound": BOUNDS[dtype], **times,
                    "library_max_abs_err": lib_err,
                    **_bound(b, t, dtype, ci.tolist())}
            cases.append(case)
            log(f"[kernels] paged_flash_attention b={b} t={t} "
                f"{case['dtype']}: max_abs_err {err:.3e} (bound "
                f"{BOUNDS[dtype]:g}), kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa-over-gather {library_ms:.4f} ms "
                f"(device, {times['ms_source']}; per call with the host: "
                f"{times['call_ms']:.4f} / {times['plain_call_ms']:.4f} / "
                f"{times['library_call_ms']:.4f} ms), bound "
                f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
            assert err <= BOUNDS[dtype], case
    return cases


# -- phase 4 -----------------------------------------------------------------

def phase_engine(dev, power_line) -> dict:
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    model = init_params(gpt_small(dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    eng = GenerationEngine(model, device=dev, num_slots=SLOTS,
                           prefill_buckets=(32, 128), page_size=PAGE,
                           queue_capacity=64)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 50304, int(n)).tolist()
               for n in rng.integers(16, 129, size=8)]
    first = {}
    count = lambda name: telemetry.counter(f"serving.decode.{name}").value
    try:
        calls0 = count("prefills") + count("steps")
        fa.paged_flash_attention.launches = 0
        t_start = time.perf_counter()
        submit = {}
        futs = []
        for i, p in enumerate(prompts):
            submit[i] = time.perf_counter()
            futs.append(eng.generate(
                p, max_new_tokens=32,
                stream=lambda tok, i=i: first.setdefault(
                    i, time.perf_counter())))
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t_start
        launches = fa.paged_flash_attention.launches
        calls = count("prefills") + count("steps") - calls0
    finally:
        eng.shutdown()
    assert all(r.reason == "length" and r.tokens.size == 32
               for r in results), results
    assert all(0 <= int(tok) < 50304 for r in results for tok in r.tokens)
    tokens = sum(r.tokens.size for r in results)
    ttft = sorted(first[i] - submit[i] for i in range(len(prompts)))
    info = {"requests": len(prompts), "new_tokens": tokens,
            "prompt_lengths": [len(p) for p in prompts],
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "setup_s": setup_s, "launches": launches, "model_calls": calls,
            "card": power_line}
    log(f"[engine] gpt_small bf16, 8 requests x 32 new tokens: "
        f"{info['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{info['ttft_p50_s'] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f} ms), "
        f"setup {setup_s:.1f} s, paged kernel launches {launches} "
        f"[{power_line}]")
    # one launch per layer per prefill or decode call, none elsewhere
    assert launches == model.num_layers * calls > 0, (launches, calls)
    del model
    torch.cuda.empty_cache()
    return info


# -- phase 5 -----------------------------------------------------------------

def phase_greedy(dev) -> dict:
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    model = init_params(gpt_small(dtype=torch.float32),
                        torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 50304, n).tolist() for n in (9, 40)]
    new = 12
    with GenerationEngine(model, device=dev, num_slots=2,
                          prefill_buckets=(16, 64), page_size=PAGE) as eng:
        results = [f.result(timeout=600) for f in
                   [eng.generate(p, max_new_tokens=new) for p in prompts]]
    checked = 0
    margins = []
    with torch.no_grad():
        for p, r in zip(prompts, results):
            seq = list(p)
            for tok in r.tokens.tolist():
                logits = model(torch.tensor([seq], device=dev))[0, -1]
                assert torch.isfinite(logits).all()
                top2 = torch.topk(logits, 2).values
                margins.append((top2[0] - top2[1]).item())
                want = int(torch.argmax(logits))
                assert tok == want, (seq, tok, want)
                seq.append(tok)
                checked += 1
    info = {"prompts": len(prompts), "tokens_checked": checked,
            "min_top2_margin": min(margins)}
    log(f"[greedy] f32 engine tokens == full-forward argmax on "
        f"{checked}/{checked} positions (min top-2 margin "
        f"{min(margins):.3e})")
    return info


# -- phase 6 -----------------------------------------------------------------

def phase_profile(dev) -> dict:
    """A separate traced run of the main path (8 requests x 8 new tokens,
    bf16): device busy share and device time by kernel. Phase 4's
    numbers are taken with the profiler off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from distkeras_tpu_torch.models.gpt import gpt_small, init_params
    from distkeras_tpu_torch.serving import GenerationEngine

    model = init_params(gpt_small(dtype=torch.bfloat16),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 50304, 100).tolist() for _ in range(8)]
    with GenerationEngine(model, device=dev, num_slots=SLOTS,
                          prefill_buckets=(32, 128), page_size=PAGE) as eng:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in [eng.generate(p, max_new_tokens=8) for p in prompts]:
                f.result(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}
    log(f"[profile] traced main path: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%), "
        f"{info['kernel_launches']} kernel launches")
    for k in info["top_kernels"]:
        log(f"[profile]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
            f"{k['name']}")
    return info


def main() -> int:
    report = {}
    try:
        report["device"] = phase_device()
        import distkeras_tpu_torch  # noqa: F401 — fails outside a checkout

        dev = torch.device("cuda:0")
        report["build"] = phase_build()
        report["kernel_cases"] = phase_kernels(dev)
        report["engine"] = phase_engine(dev, report["device"]["nvidia_smi"])
        report["greedy"] = phase_greedy(dev)
        report["profile"] = phase_profile(dev)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        log("[chip_smoke] FAILED")
        return 1
    main_case = next(c for c in report["kernel_cases"]
                     if (c["b"], c["t"], c["dtype"]) == (8, 2, "bfloat16"))
    kernels = {"kernels": [{
        "name": "paged_flash_attention",
        "route": "cuda",
        "source": "distkeras_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "distkeras_tpu/ops/pallas/flash_attention.py:435",
        "launches": report["engine"]["launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "ms_source": main_case["ms_source"],
        "shape": "decode b=8 t=2 h=12 d=64 page_size=16 pmax=64 bf16",
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=1, default=str)
    log(json.dumps(kernels))
    log(report["device"]["nvidia_smi"])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["device"]["kind"],
        "count": report["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
