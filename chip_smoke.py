"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero and prints no result):

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — nvcc builds every kernel of both paths (paged attention;
   flash-attention forward; its dq and dk/dv backward) from the sources in
   this checkout (sm_90a) into the git-ignored build directory, one nvcc
   per source, all started together;
3. kernels — the paged kernel against its plain PyTorch version on the
   card at the shapes gpt_small serving gives it (float32 with TF32 off,
   and bf16), with its time, the plain version's time, one PyTorch
   library call's time for the same function, and its bound from this
   run's data;
4. engine  — the serving path: GenerationEngine(gpt_small) in bf16 on the
   card with seeded random weights, paged (page_size 16), 8 slots,
   prefill buckets (32, 128), 8 concurrent requests of 32 new tokens;
   the paged kernel's launch count is zeroed just before and read just
   after;
5. greedy  — in float32 with TF32 off, the engine's greedy tokens for two
   prompts equal the argmax of the port's full forward (plain attention,
   no kernel) re-run over each growing prefix;
6. profile — a separate short run of the serving path under
   torch.profiler: the device's busy share and its time by kernel;
7. flash   — the three training flash kernels (forward, dq, dk/dv)
   against their plain versions as in phase 3, at the training shape
   [8, 2048, 12, 64] causal and at two small shapes;
8. train   — the training path: CausalLM at GPT-2-small widths (vocab
   50304, 12 layers x 12 heads x 768, mlp 3072, max_len 2048,
   attention="flash"), bf16 compute with float32 parameters, seeded
   weights, make_train_step(masked_lm, adamw(1e-3), accuracy) on one
   seeded batch of 8 x 2048 next-token labels: 1 warm-up and 4 timed
   steps, the flash kernels' launch counts zeroed just before and read
   just after (12 launches of each a step); then two witnesses of those
   losses: the same 5 steps through attention="full" (plain autograd
   attention, no kernel), whose losses must agree with the kernels' on
   steps 1-4 to 1e-3 relative, and the same 5 steps through the kernels
   at adamw(1e-4), whose last loss must be below its first (at 1e-3 with
   no warm-up on one repeated batch both paths overshoot on the 5th
   step, so phase 8 itself checks that the loss falls below the first
   step's within the run);
9. train profile — one more step of phase 8 under torch.profiler;
10. train identity — float32 with TF32 off, gpt_small widths at 2 layers,
   b=2, t=256: attention="flash" (the kernels) against attention="full"
   (plain autograd) in loss, every parameter's gradient and the
   parameters after one SGD step.

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


def device_kernels(prof) -> list:
    """The device kernels of a torch.profiler run: the CUDA entries of
    ``key_averages()``, less the user annotations the profiler mirrors
    onto the device timeline (ranges such as torch.optim's
    ``Optimizer.step#AdamW.step``, also recorded on the host), which
    enclose kernels already counted and would count their time twice."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host]


def device_ms(fn, iters: int = 20):
    """Mean device milliseconds a call (the sum of its CUDA kernels'
    times, from torch.profiler), or None when the profiler records no
    device time. One call runs in the profiler's warm-up step, traced but
    not counted, so that tracing is running before the counted calls (a
    profile that starts with the counted calls can miss the first
    kernel)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn(0)
        torch.cuda.synchronize()
        prof.step()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        prof.step()
    total_us = sum(e.self_device_time_total for e in device_kernels(prof))
    return total_us / 1e3 / iters if total_us > 0 else None


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi),
    logged beside the long measurements."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else ""


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
    from concurrent.futures import ThreadPoolExecutor

    from distkeras_tpu_torch.ops.kernels import _build
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    loaders = {"paged_attention": fa._kernel_lib,
               "flash_attention_fwd": lambda: fa._flash_lib("fwd"),
               "flash_attention_bwd": lambda: fa._flash_lib("bwd")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()
    wall = time.perf_counter() - t0
    info = {"wall_s": wall}
    log(f"[build] {len(loaders)} libraries in parallel in {wall:.2f} s")
    for name in loaders:
        info[name] = dict(_build.build_info[name])
        log(f"[build] {name}: nvcc {info[name]['seconds']:.2f} s -> "
            f"{info[name]['path']}")
        for line in info[name]["log"].splitlines():
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
    kernels = device_kernels(prof)
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


# -- phase 7 -----------------------------------------------------------------

#: training shape of the main path, and the two small shapes also checked
FLASH_CASES = (((8, 2048, 12, 64), True), ((1, 128, 12, 64), True),
               ((2, 256, 12, 64), False))


def _flash_bound(name, shape, causal, dtype):
    """Least time for one call on the card: each input read once and
    each output written once at the HBM rate, against its products at
    the rate of their operand types, counting visible (query, key) pairs
    only. Products of input-dtype operands (q k^T, dout v^T, and p v in
    the forward, which takes p in the input dtype) run at that dtype's
    peak; those with a float32 operand (ds k, p^T dout, ds^T q) at the
    float32 peak."""
    b, t, h, d = shape
    item = torch.finfo(dtype).bits // 8
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, rows = b * t * h * d * item, b * h * t * 4
    moved = {"fwd": 4 * tensor + rows,            # q, k, v -> o, lse
             "dq": 5 * tensor + 2 * rows,         # q, k, v, dout, lse, delta -> dq
             "dkv": 6 * tensor + 2 * rows}[name]  # ... -> dk, dv
    in_ops, f32_ops = {"fwd": (4 * d, 0), "dq": (4 * d, 2 * d),
                       "dkv": (4 * d, 4 * d)}[name]
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (in_ops * pairs / PEAK_FLOPS[dtype]
             + f32_ops * pairs / PEAK_FLOPS[torch.float32]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "flops": (in_ops + f32_ops) * pairs,
            "pairs": pairs}


def _timed(fn, iters):
    """(device ms a call from the profiler, or the events time when the
    profiler records none; events ms a call with the host; source)."""
    call = cuda_ms(fn, iters=iters, warmup=1)
    dev_ms = device_ms(fn, iters=max(2, iters // 2))
    return ((call, call, "events") if dev_ms is None
            else (dev_ms, call, "profiler"))


def phase_flash_kernels(dev) -> list:
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    cases = []
    log(f"[flash] card before: {smi_sample()} (SM clock, power, temp)")
    for (shape, causal) in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(sum(shape))
            q, k, v, dout = (torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
                for _ in range(4))
            o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal)
            delta = fa.flash_attention_delta(o_ref, dout)
            args = (q, k, v, dout, lse_ref, delta, causal)
            o, lse = fa.flash_attention_fwd(q, k, v, causal)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            dq_ref = fa.flash_attention_bwd_dq_reference(*args)
            dk_ref, dv_ref = fa.flash_attention_bwd_dkv_reference(*args)
            torch.cuda.synchronize()
            errs, ok = {}, True
            for name, got, want, grad in (
                    ("o", o, o_ref, False), ("lse", lse, lse_ref, False),
                    ("dq", dq, dq_ref, True), ("dk", dk, dk_ref, True),
                    ("dv", dv, dv_ref, True)):
                assert torch.isfinite(got).all(), name
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                if dtype == torch.float32:
                    bound = 1e-4 * scale + 1e-5 if grad else 1e-5
                else:
                    bound = 2e-2 * scale if grad else 2e-2
                errs[name] = {"max_abs_err": err, "bound": bound,
                              "max_abs_ref": scale}
                ok &= err <= bound
            del o, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref
            iters = 10 if shape[1] >= 2048 else 30
            # library yardstick: SDPA on [b, h, t, d] copies (copies not
            # timed), its forward and its backward (dq, dk, dv together)
            qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            dot = dout.transpose(1, 2).contiguous()
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            lib_err = (sdpa_out.detach().transpose(1, 2).float()
                       - o_ref.float()).abs().max().item()
            timings = {
                "fwd": (lambda i: fa.flash_attention_fwd(q, k, v, causal),
                        lambda i: fa.flash_attention_reference(q, k, v,
                                                               causal)),
                "dq": (lambda i: fa.flash_attention_bwd_dq(*args),
                       lambda i: fa.flash_attention_bwd_dq_reference(*args)),
                "dkv": (lambda i: fa.flash_attention_bwd_dkv(*args),
                        lambda i: fa.flash_attention_bwd_dkv_reference(
                            *args)),
            }
            kernels = {}
            for name, (kernel, plain) in timings.items():
                ms, call_ms, source = _timed(kernel, iters)
                plain_ms, plain_call_ms, _ = _timed(plain, max(2, iters // 3))
                kernels[name] = {"ms": ms, "call_ms": call_ms,
                                 "ms_source": source, "plain_ms": plain_ms,
                                 "plain_call_ms": plain_call_ms,
                                 **_flash_bound(name, shape, causal, dtype)}
            lib_fwd = _timed(lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters)
            lib_bwd = _timed(lambda i: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True), iters)
            kernels["fwd"]["library_ms"] = lib_fwd[0]
            for name in ("dq", "dkv"):
                kernels[name]["library_ms"] = None
                kernels[name]["library_bwd_ms"] = lib_bwd[0]
            case = {"shape": list(shape), "causal": causal,
                    "dtype": str(dtype).split(".")[-1], "errors": errs,
                    "library_fwd_max_abs_err": lib_err, "kernels": kernels}
            cases.append(case)
            del qt, kt, vt, dot, sdpa_out
            torch.cuda.empty_cache()
            err_line = ", ".join(f"{n} {e['max_abs_err']:.3e} (bound "
                                 f"{e['bound']:.3e})" for n, e in errs.items())
            log(f"[flash] {tuple(shape)} causal={causal} {case['dtype']}: "
                f"{err_line}")
            for name, kk in kernels.items():
                lib = (f"sdpa fwd {kk['library_ms']:.4f}" if name == "fwd"
                       else f"sdpa bwd (dq+dk+dv) {kk['library_bwd_ms']:.4f}")
                log(f"[flash]   {name}: kernel {kk['ms']:.4f} ms, plain "
                    f"{kk['plain_ms']:.4f} ms, {lib} ms (device, "
                    f"{kk['ms_source']}; with the host {kk['call_ms']:.4f} / "
                    f"{kk['plain_call_ms']:.4f} ms), bound "
                    f"{kk['bound_ms']:.4f} ms ({kk['bound_by']})")
            assert ok, errs
    log(f"[flash] card after: {smi_sample()}")
    return cases


# -- phase 8 -----------------------------------------------------------------

TRAIN_B, TRAIN_T = 8, 2048


def _train_model(num_layers, attention, dtype, seed):
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params

    model = CausalLM(vocab_size=50304, max_len=2048, num_layers=num_layers,
                     num_heads=12, width=768, mlp_dim=3072, dtype=dtype,
                     attention=attention)
    return init_params(model, torch.Generator().manual_seed(seed))


def _lm_batch(b, t, seed):
    """Seeded tokens with next-token labels (last position -1)."""
    x = np.random.default_rng(seed).integers(1, 50304, (b, t))
    y = np.concatenate([x[:, 1:], np.full((b, 1), -1)], axis=1)
    return {"features": x.astype(np.int32), "labels": y.astype(np.int32)}


def phase_train(dev, power_line) -> tuple:
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    set_tf32(False)
    model = _train_model(12, "flash", torch.bfloat16, seed=0)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    tx = optimizers.get("adamw", 1e-3)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx,
                                  metrics=("accuracy",))
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    metrics, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in out.items()})
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in metrics]
    median_s = statistics.median(times[1:])
    info = {"steps": len(times), "step_s": times, "median_step_s": median_s,
            "tokens_per_s": TRAIN_B * TRAIN_T / median_s,
            "peak_bytes": peak, "metrics": metrics, "launches": launches,
            "tf32": torch.backends.cuda.matmul.allow_tf32, "card": power_line,
            "card_after": smi_sample()}
    log(f"[train] gpt-2-small widths, seq {TRAIN_T}, batch {TRAIN_B}, bf16 "
        f"compute, f32 params, adamw(1e-3): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{times[0] * 1e3:.1f} ms), {info['tokens_per_s']:.0f} tokens/s, "
        f"peak {peak / 2**30:.2f} GiB, TF32 {info['tf32']}, flash launches "
        f"{launches} [{power_line}; after: {info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    assert min(losses[1:]) < losses[0], losses
    assert all(n == 12 * len(times) for n in launches.values()), launches
    return info, (state, step, batch)


def _train_losses(dev, attention, lr, steps) -> list:
    """Phase 8's configuration and batch from the same seeded weights,
    ``steps`` adamw(``lr``) steps through ``attention``: the losses."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers

    set_tf32(False)
    model = _train_model(12, attention, torch.bfloat16, seed=0)
    tx = optimizers.get("adamw", lr)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx)
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    losses = []
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
    del model, state, step
    torch.cuda.empty_cache()
    return losses


def phase_train_witness(dev, flash_losses) -> dict:
    """Two witnesses of phase 8's losses. The same steps through
    attention="full" (plain autograd attention, no kernel) must agree
    with the kernels' on the first four steps to 1e-3 relative (bf16
    compute; the 5th step's overshoot amplifies rounding differences).
    The same steps through the kernels at adamw(1e-4) must end below
    their first loss: the 5th step's rise at 1e-3 is the learning rate's,
    not the kernels'."""
    full = _train_losses(dev, "full", 1e-3, len(flash_losses))
    diff = [abs(a - b) / b for a, b in zip(flash_losses, full)]
    low_lr = _train_losses(dev, "flash", 1e-4, len(flash_losses))
    log(f"[train-witness] the same steps through attention='full': losses "
        f"{', '.join(f'{x:.4f}' for x in full)} (flash: "
        f"{', '.join(f'{x:.4f}' for x in flash_losses)}; relative "
        f"differences {', '.join(f'{x:.2e}' for x in diff)}, steps 1-4 "
        f"bound 1e-3); through the kernels at adamw(1e-4): "
        f"{', '.join(f'{x:.4f}' for x in low_lr)}")
    info = {"full_losses": full, "flash_losses": flash_losses,
            "rel_diff": diff, "flash_losses_lr_1e-4": low_lr}
    assert max(diff[:4]) <= 1e-3, info
    assert all(math.isfinite(x) for x in low_lr) and low_lr[-1] < low_lr[0], \
        info
    return info


# -- phase 9 -----------------------------------------------------------------

def phase_train_profile(state, step, batch) -> dict:
    """One more train step (phase 8's state and batch) under
    torch.profiler: device busy share and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}
    log(f"[train-profile] one traced step: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%)"
        f", {info['kernel_launches']} kernel launches")
    for k in info["top_kernels"]:
        log(f"[train-profile]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
            f"{k['name']}")
    return info


# -- phase 10 ----------------------------------------------------------------

def phase_train_identity(dev) -> dict:
    """f32, TF32 off: the flash kernels against plain autograd attention
    in the loss, every gradient, and the parameters after one SGD step."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers

    set_tf32(False)
    batch = engine.to_device(_lm_batch(2, 256, seed=5), dev)
    models = {a: _train_model(2, a, torch.float32, seed=7).to(dev)
              for a in ("flash", "full")}
    got = {}
    for attention, model in models.items():
        (loss, _), grads = engine.make_grad_fn(model, "masked_lm")(batch)
        got[attention] = (loss.item(), grads)
    loss_rel = abs(got["flash"][0] - got["full"][0]) / abs(got["full"][0])
    grad_rel = {n: ((g - got["full"][1][n]).norm()
                    / got["full"][1][n].norm().clamp(min=1e-30)).item()
                for n, g in got["flash"][1].items()}
    tx = optimizers.get("sgd", 0.1)
    for attention, model in models.items():
        state = engine.create_train_state(model, tx, device=dev)
        engine.make_train_step(model, "masked_lm", tx)(state, batch)
    param_err = max((pf - pr).abs().max().item() for pf, pr in zip(
        models["flash"].parameters(), models["full"].parameters()))
    worst = max(grad_rel, key=grad_rel.get)
    info = {"loss_flash": got["flash"][0], "loss_full": got["full"][0],
            "loss_rel": loss_rel, "max_grad_rel": grad_rel[worst],
            "worst_grad": worst, "sgd_param_max_abs_err": param_err}
    log(f"[identity] f32 flash vs full, 2 layers b=2 t=256: loss "
        f"{got['flash'][0]:.6f} vs {got['full'][0]:.6f} (rel {loss_rel:.2e}, "
        f"bound 1e-5), worst grad rel {grad_rel[worst]:.2e} ({worst}, bound "
        f"1e-4), params after one SGD step {param_err:.2e} (bound 1e-6)")
    assert loss_rel <= 1e-5 and grad_rel[worst] <= 1e-4 \
        and param_err <= 1e-6, info
    return info


def main() -> int:
    report = {}
    try:
        report["device"] = phase_device()
        import distkeras_tpu_torch  # noqa: F401 — fails outside a checkout

        dev = torch.device("cuda:0")
        card = report["device"]["nvidia_smi"]
        report["build"] = phase_build()
        report["kernel_cases"] = phase_kernels(dev)
        report["engine"] = phase_engine(dev, card)
        report["greedy"] = phase_greedy(dev)
        report["profile"] = phase_profile(dev)
        report["flash_cases"] = phase_flash_kernels(dev)
        report["train"], train_run = phase_train(dev, card)
        report["train_profile"] = phase_train_profile(*train_run)
        del train_run
        torch.cuda.empty_cache()
        report["train_witness"] = phase_train_witness(
            dev, [m["loss"] for m in report["train"]["metrics"]])
        report["train_identity"] = phase_train_identity(dev)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        log("[chip_smoke] FAILED")
        return 1
    main_case = next(c for c in report["kernel_cases"]
                     if (c["b"], c["t"], c["dtype"]) == (8, 2, "bfloat16"))
    rows = [{
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
    }]
    train_case = next(c for c in report["flash_cases"]
                      if c["shape"] == [8, 2048, 12, 64]
                      and c["dtype"] == "bfloat16")
    flash_rows = (
        ("flash_attention_fwd", "fwd", ("o", "lse"), "flash_attention_fwd.cu",
         131),
        ("flash_attention_bwd_dq", "dq", ("dq",), "flash_attention_bwd.cu",
         237),
        ("flash_attention_bwd_dkv", "dkv", ("dk", "dv"),
         "flash_attention_bwd.cu", 283))
    for name, part, outs, src, line in flash_rows:
        kk = train_case["kernels"][part]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distkeras_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"distkeras_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": report["train"]["launches"][name],
            "max_abs_err": max(train_case["errors"][o]["max_abs_err"]
                               for o in outs),
            "ms": kk["ms"], "plain_ms": kk["plain_ms"],
            "bound_ms": kk["bound_ms"], "bound_by": kk["bound_by"],
            "library_ms": kk["library_ms"],
            **({"library_bwd_ms": kk["library_bwd_ms"]}
               if "library_bwd_ms" in kk else {}),
            "ms_source": kk["ms_source"],
            "shape": "b=8 t=2048 h=12 d=64 causal bf16",
        })
    kernels = {"kernels": rows}
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
