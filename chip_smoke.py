"""Drive the PyTorch port once on one CUDA card and check what comes out.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero and prints no result):

1. device  — the card's name and power limit (nvidia-smi) and torch's view;
2. build   — nvcc builds every kernel (paged attention's two; flash-
   attention forward; its dq and dk/dv backward; the int8 product;
   GroupNorm forward and backward) from the sources in
   this checkout (sm_90a) into the git-ignored build directory, one nvcc
   per source, all started together, and logs each kernel's registers,
   spills and shared memory; the SASS of the flash forward and backward
   must hold wgmma (HGMMA) in each bf16 kernel, and the int8 product's
   integer wgmma (IGMMA) in each of its kernels, with no mma.sync (IMMA)
   left;
3. kernels — the paged kernel (a call is two launches, split over the
   keys) against its plain PyTorch version on the card (float32 with
   TF32 off, and bf16) at the shapes gpt_small serving gives it and at
   head_dim 16 (h=2) and 96, max_len 4096 at b=8 and 32768 at b=1
   (t=2), and at the chunk shape (1, 16) at cursors 16 and 32, with its
   time, the plain version's time, one PyTorch library call's time for
   the same function, and its bound from this run's data;
4. engine  — the serving path: GenerationEngine(gpt_small) in bf16 on the
   card with seeded random weights, paged (page_size 16), 8 slots,
   prefill buckets (32, 128), first 20 bursts of 8 requests of 32 new
   tokens submitted at once (each burst's tokens/s, time a model call
   and longest gap), then three windows of 128 requests of 16-128
   prompt tokens and 64 new tokens each, 8 in flight (a closed loop):
   tokens/s a window and their spread, TTFT, the longest gap between two
   token emissions and the garbage collector's time in each window;
   every declared shape (2 buckets, 4 ladder widths) is captured as a
   CUDA graph in the constructor (the capture time is in ``setup_s``,
   the graphs' memory in ``graph_pool_bytes``) and only replayed after:
   the compiles count must not move under traffic; the paged kernel's
   launch count (one a layer a replay) is zeroed just before and read
   just after;
5. greedy  — in float32 with TF32 off, the engine's greedy tokens for two
   prompts equal the argmax of the port's full forward (plain attention,
   no kernel) re-run over each growing prefix, for gpt_small and for
   gpt_tiny (head_dim 16);
6. profile — a separate run of the serving path under torch.profiler
   (32 requests of 100 prompt tokens and 16 new tokens, 8 in flight):
   the device's busy share, its time by kernel, and the kernels each
   model call (a graph replay) puts on the device; the paged kernels in
   the trace must be two for each paged call counted;
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
   parameters after one SGD step;
11. int8    — the int8 kernel against its plain version, bitwise, at the
   four products of a GPT-2-small block at 8 x 2048 rows (qkv, out, fc1,
   fc2; bf16 output), with its time, the plain version's,
   ``torch._int_mm`` plus the scale multiply, its bound and its time over
   the bound, and its schedule (the C entry's, which must equal
   ``int8_matmul.plan``);
12. int8 train — path A: phase 8's configuration with precision="int8"
   (overflow_guard(adamw(1e-3))), 1 warm-up and 4 timed steps, the int8
   kernel launched 48 times a step and each flash kernel 12; a traced
   step (48 int8 kernels in it, their device ms); witnesses: the same
   steps through the plain int8 product (step 1 equal, steps 2-5 within
   1e-4), the guard's scale 16 with no step
   skipped, step 1 under precision="bf16" within 2e-2 of int8's and not
   equal, and block 0's qkv product at least 4x as far from float32
   under int8 as under bf16;
13. groupnorm — the GroupNorm forward and backward kernels against their
   plain versions at ResNet-50 b=128 shapes (stem, stage-0 norm3, stage-3
   norm3; G=32) in bf16 and float32, with times, plain versions',
   ``F.group_norm``'s (forward, autograd backward) and bounds;
14. resnet train — path B: resnet50() (GroupNorm) in bf16 with float32
   parameters on 128 seeded uint8 224^2 images, one-hot 1000 classes,
   adamw(1e-3): 1 warm-up and 4 timed steps, 53 GroupNorm forward and 53
   backward launches a step; a traced step; witness: the same steps
   through the plain GroupNorm (steps 1-4 within 1e-3); the float32
   identity (TF32 off in matmuls and cuDNN, cuDNN deterministic) at b=2:
   kernels against plain GroupNorm in loss, gradients and parameters
   after one SGD step;
15. nf      — resnet50_nf() in bf16 at b=128, 2 steps: finite losses and
   the step time (no kernel of the port on this path);
16. rect    — phase 4's engine and traffic on the default rectangular
   pool (``page_size=None``: no paged kernel, plain attention over each
   full-context row), a traced run for its busy share, and phase 5's
   float32 greedy check on that pool;
17. sampled — ``sampling=True, temperature=0.7`` in bf16 on both pools:
   seed 321 twice gives identical streams, seed 322 another, every token
   in the vocabulary;
18. chunked — paged with ``prefill_chunk=16``: phase 5's float32 greedy
   check (the 40-token prompt in three chunks; the chunk shares the
   16-token bucket's graph); then phase 4's traffic in bf16 with
   ``prefill_chunk=32`` (the 32-token bucket's graph).

The last three lines of standard output are the kernels' JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details are
also written to ``chiprun_out/chip_smoke.json``.
"""

import json
import math
import os
import shutil
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
#: the paged kernel in bf16 is also held within this share of its plain
#: version's largest output (2 to 4 bf16 ulps of it)
PAGED_BF16_REL = 2 ** -6


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


#: card cycles of the spin that ``device_ms`` queues ahead of the timed
#: calls (~0.1 s at the H100's 1,980 MHz): longer than the host takes to
#: enqueue them
_SPIN_CYCLES = 200_000_000


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds a call: ``iters`` calls enqueued behind a
    spin of the card, so that they run back to back whatever the host's
    pace, between two CUDA events (the host's own time per call is not in
    it). One untimed call runs first. torch.profiler's kernel records
    were not used: they dropped some calls of the GroupNorm kernels, so
    that a call read 2/5 or 3/5 of its events time, one above what the
    card's memory rate allows."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    loaders = {"paged_attention": fa._kernel_lib,
               "flash_attention_fwd": lambda: fa._flash_lib("fwd"),
               "flash_attention_bwd": lambda: fa._flash_lib("bwd"),
               "int8_matmul": i8._kernel_lib,
               "groupnorm": gn._kernel_lib}
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
            if "Compiling entry function" in line:
                log(f"[build]   {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    info["groupnorm_kernels"] = _ptxas_table(info["groupnorm"]["log"])
    for name, k in info["groupnorm_kernels"].items():
        log(f"[build] groupnorm {name}: {k['registers']} registers, "
            f"{k['spill_stores']} + {k['spill_loads']} bytes spilled "
            f"(stores + loads), {k['smem']} bytes static shared memory "
            f"(the tiles are dynamic: phase 13 gives each plan's)")
    # the bf16 kernels (two forward, four backward: "sm90" in their
    # names) must multiply on the tensor cores
    for lib, n in (("flash_attention_fwd", 2), ("flash_attention_bwd", 4)):
        counts = _sass_counts(info[lib]["path"])
        info[f"{lib}_sass"] = counts
        sm90 = [c for name, c in counts.items() if "sm90" in name]
        assert len(sm90) == n and all(c["HGMMA"] > 0 for c in sm90), counts
    # the int8 product (float32 and bf16 output) on integer wgmma, with no
    # warp-level mma.sync left in the library
    counts = _sass_counts(info["int8_matmul"]["path"], ("IGMMA", "IMMA"))
    info["int8_matmul_sass"] = counts
    assert len(counts) == 2 and all(
        c["IGMMA"] > 0 and c["IMMA"] == 0 for c in counts.values()), counts
    return info


def _ptxas_table(build_log) -> dict:
    """Per kernel of a build's ``-Xptxas=-v`` output: registers, spilled
    bytes and static shared memory, keyed by the kernel's template
    (``gn_fwd_kernel<float, 4>``)."""
    import re

    table, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kernel = re.search(r"\d+(gn_\w+?_kernel)I", mangled)
            ty = "bf16" if "nv_bfloat16" in mangled else "float"
            vec = re.search(r"Li(\d+)E", mangled)
            name = (f"{kernel.group(1)}<{ty}, {vec.group(1)}>"
                    if kernel and vec else mangled)
            table[name] = {"registers": 0, "spill_stores": 0,
                           "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            table[name]["smem"] = int(m.group(1))
    return table


def _sass_counts(lib_path, ops=("HGMMA", "FFMA")) -> dict:
    """Per kernel of a built library, its count of each of ``ops`` in the
    SASS (cuobjdump): by default bf16 wgmma (HGMMA) and float32 FMA
    (FFMA)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in ops:
                counts[name][op] += f" {op}." in line or f" {op} " in line
    for name, c in counts.items():  # from the kernel's own name on
        start = max(name.rfind("flash_"), name.rfind("int8_"), 0)
        log(f"[build]   sass {name[start:][:48]}: "
            + ", ".join(f"{c[op]} {op}" for op in ops))
    return counts


# -- phase 3 -----------------------------------------------------------------

def _paged_inputs(b, t, dtype, rng, dev, h=H, d=D, pmax=PMAX, ci=None):
    """q, k_pages, v_pages, page_table, cache_index at a pool of ``pmax``
    pages a row of ``b`` rows (the engine's geometry by default): tables
    drawn from every page INCLUDING the scratch page, cursors random with
    room for the block unless ``ci`` gives them."""
    num_pages = b * pmax if pmax != PMAX else NUM_PAGES
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    q = mk(b, t, h, d)
    k = mk(num_pages + 1, PAGE, h, d)
    v = mk(num_pages + 1, PAGE, h, d)
    table = rng.permutation(num_pages + 1)[:b * pmax].reshape(b, pmax)
    ci = (rng.integers(0, pmax * PAGE - t + 1, size=b) if ci is None
          else np.full(b, ci))
    return (q, k, v, torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(ci.astype(np.int32)).to(dev))


def _bound(b, t, dtype, ci, h=H, d=D, pmax=PMAX):
    """Least time for this call on this data: each visible K/V cell, q,
    out, the table and the cursors moved once; 4*d flops per visible
    (query, key) pair at the operand type's peak. Also the bytes of the
    full fixed-length contraction (every table slot), for reference."""
    item = torch.finfo(dtype).bits // 8
    max_len = pmax * PAGE
    keys = [min(max_len, int(c) + t) for c in ci]
    pairs = sum(min(max_len, int(c) + i + 1) for c in ci for i in range(t))
    kv_bytes = 2 * sum(keys) * h * d * item
    io_bytes = 2 * b * t * h * d * item + b * pmax * 4 + b * 4
    flops = 4 * d * h * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    full_bytes = 2 * b * pmax * PAGE * h * d * item + io_bytes
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": kv_bytes + io_bytes, "flops": flops,
            "bound_full_pool_ms": full_bytes / HBM_BYTES_PER_S * 1e3}


#: phase 3's cases: (b, t, heads, head_dim, pages a row[, cursor]).
#: gpt_small's serving geometry (decode at b=1 and 8, a 128-token
#: prefill), then shapes the first kernel refused: gpt_tiny's head_dim
#: 16, head_dim 96, and 4096- and 32768-key contexts; then the chunk
#: calls of a 40-token prompt under prefill_chunk=16 (its second and
#: third chunks, at cursors 16 and 32)
PAGED_CASES = (((1, 2, H, D, PMAX), (8, 2, H, D, PMAX), (1, 128, H, D, PMAX)),
               ((8, 2, 2, 16, PMAX), (8, 2, 8, 96, PMAX), (8, 2, H, D, 256),
                (1, 2, H, D, 2048)),
               ((1, 16, H, D, PMAX, 16), (1, 16, H, D, PMAX, 32)))


def phase_kernels(dev) -> list:
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    cases = []
    # gpt_small's cases first, in both dtypes, so that they draw the same
    # inputs as in earlier versions of this script
    runs = [(dtype, case) for group in PAGED_CASES
            for dtype in (torch.float32, torch.bfloat16) for case in group]
    set_tf32(False)
    for dtype, (b, t, h, d, pmax, *cursor) in runs:
        q, k, v, table, ci = _paged_inputs(b, t, dtype, rng, dev, h, d,
                                           pmax, *cursor)
        args = (q, k, v, table, ci)
        got = fa.paged_flash_attention(*args)
        want = fa.paged_flash_attention_reference(*args)
        torch.cuda.synchronize()
        assert got.shape == want.shape == q.shape
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        # bf16 also within a few ulps of the largest output, which over
        # tens of thousands of keys is a few hundredths
        scale = want.float().abs().max().item()
        bound = BOUNDS[dtype]
        if dtype == torch.bfloat16:
            bound = min(bound, PAGED_BF16_REL * scale)
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
        max_len = pmax * PAGE
        dense = [(kk[table.long()].reshape(b, max_len, h, d).transpose(1, 2),
                  vv[table.long()].reshape(b, max_len, h, d).transpose(1, 2))
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
        # device time (calls queued behind a spin), and the events
        # time of back-to-back calls, which includes the host
        times = {}
        for name, fn in (("ms", kernel), ("plain_ms", plain),
                         ("library_ms", library)):
            times[name], times[name.replace("ms", "call_ms")], \
                times[name.replace("ms", "ms_source")] = _timed(fn, 30)
        ms, plain_ms, library_ms = (times["ms"], times["plain_ms"],
                                    times["library_ms"])
        del dense, pools
        torch.cuda.empty_cache()
        case = {"b": b, "t": t, "h": h, "d": d, "max_len": max_len,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "max_abs_ref": scale, "bound": bound,
                **times, "split": fa.split_keys(max_len, b * h),
                "library_max_abs_err": lib_err,
                **({"cache_index": cursor[0]} if cursor else {}),
                **_bound(b, t, dtype, ci.tolist(), h, d, pmax)}
        cases.append(case)
        at = f" cache_index={cursor[0]}" if cursor else ""
        log(f"[kernels] paged_flash_attention b={b} t={t} h={h} d={d} "
            f"max_len={max_len}{at} {case['dtype']}: max_abs_err {err:.3e} "
            f"(bound {bound:.3g}), kernel {ms:.4f} ms (split "
            f"{case['split']}), plain {plain_ms:.4f} ms, "
            f"sdpa-over-gather {library_ms:.4f} ms (device, "
            f"{times['ms_source']}; per call with the host: "
            f"{times['call_ms']:.4f} / {times['plain_call_ms']:.4f} / "
            f"{times['library_call_ms']:.4f} ms), bound "
            f"{case['bound_ms']:.4f} ms ({case['bound_by']})")
        assert err <= bound, case
    return cases


# -- phase 4 -----------------------------------------------------------------

#: the serving engine's declared shapes at gpt_small (phases 4, 6, 16-18)
ENGINE_KW = dict(num_slots=SLOTS, prefill_buckets=(32, 128),
                 queue_capacity=64)


#: phase 4's traffic (also phases 16 and 18's): SERVE_REQUESTS requests
#: of 16-128 prompt tokens and SERVE_NEW new tokens each, SLOTS of them
#: in flight (a closed loop: a request is submitted as one completes),
#: served SERVE_WINDOWS times over on one engine. At ~3,500 tokens/s a
#: window lasts ~2.3 s, the eager engine's ~11 s.
SERVE_REQUESTS = 128
SERVE_NEW = 64
SERVE_WINDOWS = 3
#: before the windows, BURSTS bursts of SLOTS requests of BURST_NEW new
#: tokens each, submitted at once (~0.07 s each on graphs): how much a
#: run that short varies, and whether a slow one stalled (its longest
#: gap) or ran slow throughout (its time a model call)
BURSTS = 20
BURST_NEW = 32


def _serving_prompts():
    """Phase 4's prompts: SERVE_REQUESTS of 16-128 tokens."""
    rng = np.random.default_rng(1)
    return [rng.integers(1, 50304, int(k)).tolist()
            for k in rng.integers(16, 129, size=SERVE_REQUESTS)]


def _gpt_small_bf16():
    from distkeras_tpu_torch.models.gpt import gpt_small, init_params

    return init_params(gpt_small(dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0))


def _serve_window(eng, prompts, new) -> dict:
    """Serve ``prompts`` through ``eng`` with ``new`` new tokens each,
    SLOTS requests in flight: tokens/s, TTFT (submission to first token),
    and what would show a stall: the longest gap between two of the
    scheduler's token emissions, with its start from the window's, beside
    the window's mean time a model call, and the time Python's garbage
    collector ran in the window."""
    import gc
    import threading

    from distkeras_tpu_torch import telemetry

    prefill = ("chunk.steps" if "prefill_chunk" in eng.compiled_executables
               else "prefills")
    calls = lambda: sum(telemetry.counter(f"serving.decode.{name}").value
                        for name in (prefill, "steps"))
    free = threading.Semaphore(SLOTS)
    submit, first, emits, gc_runs = {}, {}, [], []

    def on_token(i):
        def stream(tok):
            now = time.perf_counter()
            emits.append(now)
            first.setdefault(i, now)
        return stream

    def on_gc(phase, info):
        gc_runs.append(time.perf_counter())

    calls0 = calls()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            assert free.acquire(timeout=600), "no request completed"
            submit[i] = time.perf_counter()
            futs.append(eng.generate(p, max_new_tokens=new,
                                     stream=on_token(i)))
            futs[-1].add_done_callback(lambda f: free.release())
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    n_calls = calls() - calls0
    assert all(r.reason == "length" and r.tokens.size == new
               for r in results), results
    assert all(0 <= int(tok) < 50304 for r in results for tok in r.tokens)
    tokens = sum(r.tokens.size for r in results)
    ttft = sorted(first[i] - submit[i] for i in range(len(prompts)))
    gaps = np.diff([t0] + emits)
    at = int(np.argmax(gaps))
    return {"requests": len(prompts), "new_tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
            "model_calls": n_calls, "ms_per_call": wall / n_calls * 1e3,
            "max_gap_ms": float(gaps[at]) * 1e3,
            "max_gap_at_s": ([t0] + emits)[at] - t0,
            "gc_s": sum(b - a for a, b in zip(gc_runs[::2], gc_runs[1::2])),
            "gc_runs": len(gc_runs) // 2}


def _serve_windows(eng) -> dict:
    """SERVE_WINDOWS windows of phase 4's traffic back to back on ``eng``:
    each window's numbers, the median and spread of their tokens/s, and
    the paged kernel's launches (zeroed just before the first window,
    read just after the last) beside the model calls of all of them."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    prompts = _serving_prompts()
    fa.paged_flash_attention.launches = 0
    runs = [_serve_window(eng, prompts, SERVE_NEW)
            for _ in range(SERVE_WINDOWS)]
    launches = fa.paged_flash_attention.launches
    rates = [r["tokens_per_s"] for r in runs]
    return {"windows": runs, "tokens_per_s": statistics.median(rates),
            "tokens_per_s_min": min(rates), "tokens_per_s_max": max(rates),
            "ttft_p50_s": statistics.median(r["ttft_p50_s"] for r in runs),
            "ttft_max_s": max(r["ttft_max_s"] for r in runs),
            "max_gap_ms": max(r["max_gap_ms"] for r in runs),
            "launches": launches,
            "model_calls": sum(r["model_calls"] for r in runs)}


def _engine_run(dev, model, power_line, tag, **kw) -> dict:
    """Build ``GenerationEngine(model, **ENGINE_KW, **kw)`` (every shape
    captured as a CUDA graph in the constructor: ``setup_s``) and serve
    phase 4's traffic (:func:`_serve_windows`). Asserts that the compiles
    count and ``compiled_executables`` do not move under traffic."""
    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    compiles = telemetry.counter("serving.decode.compiles")
    compiles0 = compiles.value
    t0 = time.perf_counter()
    eng = GenerationEngine(model, device=dev, **ENGINE_KW, **kw)
    setup_s = time.perf_counter() - t0
    captured = compiles.value - compiles0
    declared = eng.compiled_executables
    try:
        bursts = [_serve_window(eng, _serving_prompts()[:SLOTS], BURST_NEW)
                  for _ in range(BURSTS)]
        info = _serve_windows(eng)
        assert compiles.value - compiles0 == captured, "captured late"
        assert eng.compiled_executables == declared
    finally:
        eng.shutdown()
    info.update(setup_s=setup_s, compiles=captured,
                compiled_executables=declared,
                graph_pool_bytes=eng.graph_pool_bytes, card=power_line,
                bursts=bursts)
    rates = [b["tokens_per_s"] for b in bursts]
    slow = bursts[int(np.argmin(rates))]
    log(f"[{tag}] {BURSTS} bursts of {SLOTS} requests x {BURST_NEW} new "
        f"tokens at once: tokens/s min {min(rates):.1f}, median "
        f"{statistics.median(rates):.1f}, max {max(rates):.1f} (first "
        f"{rates[0]:.1f}); the slowest: {slow['ms_per_call']:.3f} ms a "
        f"model call, longest gap {slow['max_gap_ms']:.1f} ms at "
        f"{slow['max_gap_at_s']:.3f} s, gc {slow['gc_s'] * 1e3:.1f} ms")
    for k, w in enumerate(info["windows"]):
        log(f"[{tag}] window {k}: {w['requests']} requests x {SERVE_NEW} "
            f"new tokens, {SLOTS} in flight: {w['tokens_per_s']:.1f} "
            f"tokens/s in {w['wall_s']:.3f} s, TTFT p50 "
            f"{w['ttft_p50_s'] * 1e3:.1f} ms (max "
            f"{w['ttft_max_s'] * 1e3:.1f} ms), {w['model_calls']} model "
            f"calls ({w['ms_per_call']:.3f} ms a call), longest gap "
            f"{w['max_gap_ms']:.1f} ms at {w['max_gap_at_s']:.3f} s, gc "
            f"{w['gc_s'] * 1e3:.1f} ms in {w['gc_runs']} runs")
    log(f"[{tag}] gpt_small bf16: median {info['tokens_per_s']:.1f} "
        f"tokens/s (min {info['tokens_per_s_min']:.1f}, max "
        f"{info['tokens_per_s_max']:.1f}) over {len(info['windows'])} "
        f"windows, setup {setup_s:.2f} s for {captured} CUDA graphs "
        f"{declared} holding {eng.graph_pool_bytes / 2**20:.1f} MiB, "
        f"{info['model_calls']} model calls, paged kernel launches "
        f"{info['launches']} [{power_line}]")
    return info


def phase_engine(dev, power_line) -> dict:
    """The main path: the paged engine (page_size 16) through its CUDA
    graphs, one launch of the paged kernel per layer per model call."""
    model = _gpt_small_bf16()
    info = _engine_run(dev, model, power_line, "engine", page_size=PAGE)
    # one launch per layer per prefill or decode call, none elsewhere
    assert info["launches"] == model.num_layers * info["model_calls"] > 0, (
        info["launches"], info["model_calls"])
    assert info["compiles"] == 6, info["compiled_executables"]
    del model
    torch.cuda.empty_cache()
    return info


# -- phase 5 -----------------------------------------------------------------

def _greedy(dev, model, seed, **kw) -> dict:
    """The engine's greedy tokens for two prompts of 9 and 40 tokens
    (float32, TF32 off) against the argmax of the model's full forward
    (plain attention, no kernel) re-run over each growing prefix. Paged
    (page_size 16) unless ``kw`` says otherwise."""
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.serving import GenerationEngine

    set_tf32(False)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, model.vocab_size, n).tolist()
               for n in (9, 40)]
    new = 12
    kw = {"page_size": PAGE, **kw}
    fa.paged_flash_attention.launches = 0
    with GenerationEngine(model, device=dev, num_slots=2,
                          prefill_buckets=(16, 64), **kw) as eng:
        results = [f.result(timeout=600) for f in
                   [eng.generate(p, max_new_tokens=new) for p in prompts]]
    launches = fa.paged_flash_attention.launches
    if kw["page_size"] is not None:
        assert launches > 0, "the engine did not reach the paged kernel"
    else:
        assert launches == 0, "the rectangular pool runs no paged kernel"
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
    return {"prompts": len(prompts), "tokens_checked": checked,
            "min_top2_margin": min(margins), "paged_launches": launches}


def phase_greedy(dev, tag="greedy", **kw) -> dict:
    """gpt_small (head_dim 64) and gpt_tiny (head_dim 16, which the first
    paged kernel refused) served greedily in float32 on the card."""
    from distkeras_tpu_torch.models.gpt import (gpt_small, gpt_tiny,
                                                init_params)

    info = {}
    for name, make, seed in (("gpt_small", gpt_small, 2),
                             ("gpt_tiny", gpt_tiny, 6)):
        model = init_params(make(dtype=torch.float32),
                            torch.Generator().manual_seed(seed))
        info[name] = _greedy(dev, model, seed + 1, **kw)
        log(f"[{tag}] {name} (head_dim {model.width // model.num_heads}) "
            f"f32 engine tokens == full-forward argmax on "
            f"{info[name]['tokens_checked']}/{info[name]['tokens_checked']} "
            f"positions (min top-2 margin "
            f"{info[name]['min_top2_margin']:.3e}; paged kernel calls "
            f"{info[name]['paged_launches']})")
        del model
    return info


# -- phase 6 -----------------------------------------------------------------

#: the traced run's traffic (phases 6 and 16): TRACE_REQUESTS requests of
#: 100 prompt tokens and TRACE_NEW new tokens each, SLOTS in flight
TRACE_REQUESTS = 32
TRACE_NEW = 16


def _traced_serve(eng, tag) -> dict:
    """The traced run's traffic under torch.profiler: the device's busy
    share, its time by kernel, and the kernels a model call (a graph
    replay) put on the device: all of them, and the paged kernel's two,
    beside the paged calls the wrapper counted (zeroed just before, read
    just after)."""
    from torch.profiler import ProfilerActivity, profile

    from distkeras_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 50304, 100).tolist()
               for _ in range(TRACE_REQUESTS)]
    fa.paged_flash_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_calls = _serve_window(eng, prompts, TRACE_NEW)["model_calls"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = fa.paged_flash_attention.launches
    kernels = device_kernels(prof)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    paged = sum(e.count for e in kernels
                if "paged_logits_kernel" in e.key
                or "paged_values_kernel" in e.key)
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "model_calls": n_calls, "paged_calls_counted": counted,
            "paged_kernels_traced": paged,
            "kernels_per_call": sum(e.count for e in kernels) / n_calls,
            "paged_kernels_per_call": paged / n_calls,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}
    log(f"[{tag}] traced serving run: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%), "
        f"{info['kernel_launches']} kernels on the device in {n_calls} "
        f"model calls ({info['kernels_per_call']:.1f} a call), paged "
        f"kernels {paged} ({info['paged_kernels_per_call']:.1f} a call) "
        f"for {counted} counted paged calls")
    for k in info["top_kernels"]:
        log(f"[{tag}]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
            f"{k['name']}")
    return info


def phase_profile(dev) -> dict:
    """A separate traced run of the main path (bf16, the traced run's
    traffic): device busy share and device time by kernel. Phase 4's
    numbers are taken with the profiler off."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    with GenerationEngine(model, device=dev, page_size=PAGE,
                          **ENGINE_KW) as eng:
        info = _traced_serve(eng, "profile")
    # every replay launched its layers' paged calls, and the trace holds
    # their kernels, two a call: the count a replay adds is the count the
    # card ran
    assert info["paged_calls_counted"] == (
        model.num_layers * info["model_calls"]) > 0, info
    assert info["paged_kernels_traced"] == 2 * info["paged_calls_counted"], (
        info)
    del model
    torch.cuda.empty_cache()
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
    peak. Those with a float32 operand (ds k, p^T dout, ds^T q): for
    float32 inputs at the float32 peak; for bf16 inputs as three bf16
    tensor-core products (the float32 operand split into three bf16
    terms, the fastest float32-accurate route on this card), three times
    their flops at the bf16 peak."""
    b, t, h, d = shape
    item = torch.finfo(dtype).bits // 8
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    tensor, rows = b * t * h * d * item, b * h * t * 4
    moved = {"fwd": 4 * tensor + rows,            # q, k, v -> o, lse
             "dq": 5 * tensor + 2 * rows,         # q, k, v, dout, lse, delta -> dq
             "dkv": 6 * tensor + 2 * rows}[name]  # ... -> dk, dv
    in_ops, f32_ops = {"fwd": (4 * d, 0), "dq": (4 * d, 2 * d),
                       "dkv": (4 * d, 4 * d)}[name]
    split = 3 if dtype == torch.bfloat16 and f32_ops else 0
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    if split:
        t_ops = (in_ops + split * f32_ops) * pairs / PEAK_FLOPS[dtype] * 1e3
    else:
        t_ops = (in_ops * pairs / PEAK_FLOPS[dtype]
                 + f32_ops * pairs / PEAK_FLOPS[torch.float32]) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "flops": (in_ops + f32_ops) * pairs,
            "pairs": pairs, "split_terms": split}


def _timed(fn, iters):
    """(device ms a call, events queued behind a spin; events ms a call
    with the host; source)."""
    call = cuda_ms(fn, iters=iters, warmup=1)
    return device_ms(fn, iters=iters), call, "queued events"


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


def _train_model(num_layers, attention, dtype, seed, precision=None):
    from distkeras_tpu_torch.models.gpt import CausalLM, init_params

    model = CausalLM(vocab_size=50304, max_len=2048, num_layers=num_layers,
                     num_heads=12, width=768, mlp_dim=3072, dtype=dtype,
                     attention=attention, precision=precision)
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

def phase_train_profile(state, step, batch, tag="train-profile") -> dict:
    """One more train step (a train phase's state and batch) under
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
    gn = [e for e in kernels if "gn_fwd_kernel" in e.key
          or "gn_bwd_kernel" in e.key]
    int8 = [e for e in kernels if "int8_matmul" in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]
    info = {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "groupnorm_device_ms": sum(e.self_device_time_total
                                       for e in gn) / 1e3,
            "groupnorm_kernel_launches": sum(e.count for e in gn),
            "int8_device_ms": sum(e.self_device_time_total
                                  for e in int8) / 1e3,
            "int8_kernel_launches": sum(e.count for e in int8),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}
    log(f"[{tag}] one traced step: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy_s * 1e3:.1f} ms ({100 * info['device_busy_share']:.1f}%)"
        f", {info['kernel_launches']} kernel launches")
    if gn:
        log(f"[{tag}] GroupNorm kernels: {info['groupnorm_device_ms']:.3f} "
            f"device ms over {info['groupnorm_kernel_launches']} launches "
            f"({100 * info['groupnorm_device_ms'] / 1e3 / busy_s:.1f}% of "
            f"the busy time)")
    if int8:
        log(f"[{tag}] int8 product: {info['int8_device_ms']:.3f} device ms "
            f"over {info['int8_kernel_launches']} launches")
    for k in info["top_kernels"]:
        log(f"[{tag}]   {k['device_ms']:9.3f} ms  x{k['count']:<5d} "
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


# -- phase 11 ----------------------------------------------------------------

#: the four int8 products of a GPT-2-small block at batch 8 x 2048 (M
#: rows): (name, K, N)
INT8_CASES = (("qkv", 768, 2304), ("out", 768, 768), ("fc1", 768, 3072),
              ("fc2", 3072, 768))
INT8_M = 16384
PEAK_INT8_OPS = 1979e12


def _int8_bound(m, k, n, out_dtype):
    """Least time for one product: qx, qw read once and the output
    written once at the HBM rate, against 2*M*N*K int8 operations at the
    int8 tensor-core peak."""
    out_item = torch.finfo(out_dtype).bits // 8
    moved = m * k + n * k + m * n * out_item + 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / PEAK_INT8_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": moved, "ops": 2 * m * n * k}


def phase_int8_kernel(dev) -> list:
    """The int8 kernel against its plain version at the four products
    of the int8 train path (bf16 output, as the path writes it), bitwise;
    with its time, the plain version's, ``torch._int_mm`` plus the scale
    multiply (the library yardstick) and the bound."""
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for name, k, n in INT8_CASES:
        rng = np.random.default_rng(k + n)
        qx = torch.from_numpy(rng.integers(-127, 128, (INT8_M, k))
                              .astype(np.int8)).to(dev)
        qw = torch.from_numpy(rng.integers(-127, 128, (n, k))
                              .astype(np.int8)).to(dev)
        sxw = torch.tensor(rng.uniform(1e-4, 1e-2), dtype=torch.float32,
                           device=dev)
        out_dtype = torch.bfloat16
        got = i8.int8_matmul_dequant(qx, qw, sxw, out_dtype)
        want = i8.int8_matmul_dequant_reference(qx, qw, sxw, out_dtype)
        lib = (torch._int_mm(qx, qw.t()).float() * sxw).to(out_dtype)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (lib.float() - want.float()).abs().max().item()
        plan = i8.kernel_plan(INT8_M, n, k, out_dtype, dev)
        assert plan == i8.plan(INT8_M, n, k, out_dtype, sms), plan
        ms, call_ms, source = _timed(
            lambda i: i8.int8_matmul_dequant(qx, qw, sxw, out_dtype), 30)
        plain_ms, _, _ = _timed(
            lambda i: i8.int8_matmul_dequant_reference(qx, qw, sxw,
                                                       out_dtype), 6)
        lib_ms, _, _ = _timed(lambda i: (torch._int_mm(qx, qw.t()).float()
                                         * sxw).to(out_dtype), 30)
        case = {"name": name, "m": INT8_M, "k": k, "n": n,
                "out_dtype": "bfloat16", "bitwise_equal": torch.equal(
                    got, want), "max_abs_err": err,
                "library_max_abs_err": lib_err, "ms": ms, "call_ms": call_ms,
                "ms_source": source, "plain_ms": plain_ms,
                "library_ms": lib_ms, **_int8_bound(INT8_M, k, n, out_dtype),
                "plan": plan._asdict()}
        case["x_bound"] = ms / case["bound_ms"]
        cases.append(case)
        log(f"[int8] {name} [{INT8_M}, {k}] x [{n}, {k}] -> bf16: bitwise "
            f"{case['bitwise_equal']} (max abs err {err:.3e}; _int_mm "
            f"{lib_err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"_int_mm + scale {lib_ms:.4f} ms ({source}; with the host "
            f"{call_ms:.4f} ms), bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']}), {case['x_bound']:.2f}x the bound; plan "
            f"{tuple(plan)}")
        assert case["bitwise_equal"], case
        del qx, qw, got, want, lib
    torch.cuda.empty_cache()
    return cases


# -- phase 12 ----------------------------------------------------------------

def _int8_train_run(dev, precision, steps, timed=False):
    """Phase 8's configuration under ``precision``: adamw(1e-3), wrapped
    in overflow_guard where the policy scales the loss, ``steps`` steps
    on the seeded batch. Returns (losses, state, step, batch, info)."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch import precision as precision_lib
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import flash_attention as fa
    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    set_tf32(False)
    model = _train_model(12, "flash", torch.bfloat16, seed=0,
                         precision=precision)
    policy = precision_lib.get_policy(precision)
    tx = optimizers.get("adamw", 1e-3)
    if policy.loss_scale != 1.0:
        tx = precision_lib.overflow_guard(tx, policy)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "masked_lm", tx,
                                  precision=precision)
    batch = engine.to_device(_lm_batch(TRAIN_B, TRAIN_T, seed=1), dev)
    kernels = (i8.int8_matmul_dequant, fa.flash_attention_fwd,
               fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    info = {"launches": {k.__name__: k.launches for k in kernels},
            "step_s": times, "peak_bytes": torch.cuda.max_memory_allocated(
                dev)}
    return losses, state, step, batch, info


def phase_int8_train(dev, power_line) -> tuple:
    """Path A: step_probe's gpt configuration with precision="int8" on
    the card, 1 warm-up and 4 timed steps; every block Dense through the
    int8 kernel (48 launches a step), attention through the flash kernels
    (12 of each a step)."""
    losses, state, step, batch, run = _int8_train_run(dev, "int8", 5)
    guard = state.opt_state
    median_s = statistics.median(run["step_s"][1:])
    info = {"losses": losses, "step_s": run["step_s"],
            "median_step_s": median_s,
            "tokens_per_s": TRAIN_B * TRAIN_T / median_s,
            "peak_bytes": run["peak_bytes"], "launches": run["launches"],
            "loss_scale": guard.scale, "good_steps": guard.good_steps,
            "card": power_line, "card_after": smi_sample()}
    log(f"[int8-train] gpt-2-small widths, seq {TRAIN_T}, batch {TRAIN_B}, "
        f"precision='int8', overflow_guard(adamw(1e-3)): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{run['step_s'][0] * 1e3:.1f} ms), {info['tokens_per_s']:.0f} "
        f"tokens/s, peak {run['peak_bytes'] / 2**30:.2f} GiB, launches "
        f"{run['launches']}, loss scale {guard.scale} after "
        f"{guard.good_steps} clean steps [{power_line}; after: "
        f"{info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    steps = len(losses)
    # witness (ii): the guard's scale is still the policy's 16, no step
    # skipped
    assert guard.scale == 16.0 and guard.good_steps == steps, info
    assert run["launches"]["int8_matmul_dequant"] == 48 * steps, run
    assert all(run["launches"][k] == 12 * steps for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")), run
    return info, (state, step, batch)


def _qkv_errors(dev) -> tuple:
    """Relative errors (norm of the difference over the norm) of the
    first block's qkv product on phase 12's batch, under int8 and under
    a bf16 product, each against the float32 product of the same bf16
    operands: int8 rounds every operand to one of 255 codes, bf16 only
    the output, so the first is an order of magnitude above the second."""
    import torch.nn.functional as F

    model = _train_model(1, "flash", torch.bfloat16, seed=0,
                         precision="int8").to(dev)
    qkv = model.layers[0].attn.qkv
    seen = []
    hook = qkv.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    ids = torch.from_numpy(_lm_batch(TRAIN_B, TRAIN_T, seed=1)["features"])
    with torch.no_grad():
        model(ids.to(dev))
        hook.remove()
        x = seen[0]
        w, b = qkv.weight.to(x.dtype), qkv.bias.to(x.dtype)
        want = F.linear(x.float(), w.float(), b.float())
        errors = tuple(((y.float() - want).norm() / want.norm()).item()
                       for y in (qkv(x), F.linear(x, w, b)))
    del model, seen, x, want
    torch.cuda.empty_cache()
    return errors


def phase_int8_witness(dev, int8_losses) -> dict:
    """Witnesses (i) and (iii) of phase 12 ((ii), the guard's scale 16
    with no step skipped, is asserted there): (i) the same steps with the
    int8 product swapped for its plain version (in this script only):
    step 1's loss equal, steps 2-5 within 1e-4 relative; (iii) step 1
    under precision="bf16" within 2e-2 relative of int8's and not equal
    to it, and, since a loss cannot tell int8 from bf16 rounding, the
    first block's qkv product on the same batch under int8 at least 4x
    as far from float32 as under bf16 (quantization ran)."""
    from unittest import mock

    from distkeras_tpu_torch.ops.kernels import int8_matmul as i8

    with mock.patch.object(i8, "int8_matmul_dequant",
                           i8.int8_matmul_dequant_reference):
        plain, *_ = _int8_train_run(dev, "int8", len(int8_losses))
    torch.cuda.empty_cache()
    bf16, *_ = _int8_train_run(dev, "bf16", 1)
    torch.cuda.empty_cache()
    qkv_int8, qkv_bf16 = _qkv_errors(dev)
    diff = [abs(a - b) / abs(b) for a, b in zip(int8_losses, plain)]
    bf16_rel = abs(bf16[0] - int8_losses[0]) / abs(bf16[0])
    info = {"plain_int8_losses": plain, "rel_diff": diff,
            "bf16_step1_loss": bf16[0], "bf16_step1_rel": bf16_rel,
            "qkv_rel_err_int8": qkv_int8, "qkv_rel_err_bf16": qkv_bf16}
    log(f"[int8-witness] plain int8 product: losses "
        f"{', '.join(f'{x:.6f}' for x in plain)} (kernel "
        f"{', '.join(f'{x:.6f}' for x in int8_losses)}; relative "
        f"differences {', '.join(f'{x:.2e}' for x in diff)}, step 1 must be "
        f"equal, steps 2-5 within 1e-4); bf16 step 1 {bf16[0]:.6f} "
        f"(relative {bf16_rel:.2e} from int8's, bound 2e-2, must differ); "
        f"block 0 qkv against float32: int8 {qkv_int8:.3e}, bf16 "
        f"{qkv_bf16:.3e} (int8 must be at least 4x bf16)")
    assert plain[0] == int8_losses[0], info
    assert max(diff[1:]) <= 1e-4, info
    assert 0 < bf16_rel <= 2e-2, info
    assert qkv_int8 >= 4 * qkv_bf16 and qkv_int8 <= 5e-2, info
    return info


# -- phase 13 ----------------------------------------------------------------

#: ResNet-50 at b=128, 224^2: one norm of each C/G class (2: the stem,
#: 4, 8: stage-0 norm3, 16, 32, 64: stage-3 norm3), all on the cluster
#: path
GN_CASES = ((128, 12544, 64), (128, 784, 128), (128, 3136, 256),
            (128, 784, 512), (128, 196, 1024), (128, 49, 2048))
#: a 512^2 stem in float32: the streaming path, forward and backward
GN_STREAM_CASE = (2, 65536, 64)
GN_GROUPS = 32


def _gn_bound(shape, dtype, backward):
    """Least time for one call: each input read once and each output
    written once at the HBM rate (x -> y plus gamma, beta, stats forward;
    x, dy, gamma, stats -> dx plus the per-sample partials backward)."""
    b, hw, c = shape
    item = torch.finfo(dtype).bits // 8
    tensor = b * hw * c * item
    stats = b * 2 * GN_GROUPS * 4
    moved = (3 * tensor + c * 4 + stats + 2 * b * c * 4 if backward
             else 2 * tensor + 2 * c * 4 + stats)
    return {"bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": moved}


def _gn_errors(got, want):
    """y, dx and the partials bitwise; the stats within one float32 ulp
    (a float64 sum rounded once, csrc/groupnorm.cu); with each output's
    largest error."""
    errs, ok = {}, True
    for name in ("y", "stats", "dx", "dgamma_p", "dbeta_p"):
        g, w = got[name], want[name]
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - w.float()).abs().max().item()
        if name == "stats":
            ulp = torch.nextafter(w.abs(), torch.full_like(w, math.inf)) \
                - w.abs()
            good = bool(((g - w).abs() <= ulp).all())
        else:
            good = torch.equal(g, w)
        errs[name] = {"max_abs_err": err, "bitwise": torch.equal(g, w),
                      "max_abs_ref": w.float().abs().max().item()}
        ok &= good
    return errs, ok


def phase_gn_kernels(dev) -> list:
    """The GroupNorm kernels against their plain versions at one
    ResNet-50 b=128 norm of each C/G class, bf16 and float32 (TF32 off),
    and at the streaming case: bitwise (stats within one ulp), with each
    call's plan, the kernels' times, their bounds and ``F.group_norm``'s
    (forward) and its autograd backward on the same tensors viewed as
    NCHW; the plain versions' times at the stem."""
    import torch.nn.functional as F

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    cases = []
    runs = [(shape, dtype) for shape in GN_CASES
            for dtype in (torch.bfloat16, torch.float32)]
    runs.append((GN_STREAM_CASE, torch.float32))
    for shape, dtype in runs:
        b, hw, c = shape
        side = int(round(math.sqrt(hw)))
        rng = np.random.default_rng(hw + c)
        mk = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        x, dy = mk(*shape).to(dtype), mk(*shape).to(dtype)
        gamma, beta = 1.0 + 0.1 * mk(c), 0.1 * mk(c)
        y, stats = gn.group_norm_fwd(x, gamma, beta, GN_GROUPS)
        y_ref, stats_ref = gn.group_norm_fwd_reference(
            x, gamma, beta, GN_GROUPS, 1e-6)
        dx, dgp, dbp = gn.group_norm_bwd(x, gamma, stats_ref, dy, GN_GROUPS)
        dx_ref, dgp_ref, dbp_ref = gn.group_norm_bwd_reference(
            x, gamma, stats_ref, dy, GN_GROUPS)
        torch.cuda.synchronize()
        errs, ok = _gn_errors(
            {"y": y, "stats": stats, "dx": dx, "dgamma_p": dgp,
             "dbeta_p": dbp},
            {"y": y_ref, "stats": stats_ref, "dx": dx_ref,
             "dgamma_p": dgp_ref, "dbeta_p": dbp_ref})
        del y, y_ref, dx, dx_ref
        # library yardstick: F.group_norm over the NCHW view
        # (channels_last memory) of the same tensor
        xt = x.view(b, side, side, c).permute(0, 3, 1, 2)
        dyt = dy.view(b, side, side, c).permute(0, 3, 1, 2)
        xg = xt.detach().requires_grad_()
        gg, bg = (gamma.to(dtype).requires_grad_(),
                  beta.to(dtype).requires_grad_())
        lib_out = F.group_norm(xg, GN_GROUPS, gg, bg, 1e-6)
        iters = 10 if b * hw * c > 5e7 else 30
        plain = shape == GN_CASES[0]
        kernels = {}
        for part, backward in (("fwd", False), ("bwd", True)):
            if backward:
                call = lambda i: gn.group_norm_bwd(x, gamma, stats_ref, dy,
                                                   GN_GROUPS)
                ref = lambda i: gn.group_norm_bwd_reference(
                    x, gamma, stats_ref, dy, GN_GROUPS)
                lib = lambda i: torch.autograd.grad(
                    lib_out, (xg, gg, bg), dyt, retain_graph=True)
            else:
                call = lambda i: gn.group_norm_fwd(x, gamma, beta, GN_GROUPS)
                ref = lambda i: gn.group_norm_fwd_reference(
                    x, gamma, beta, GN_GROUPS, 1e-6)
                lib = lambda i: F.group_norm(xt, GN_GROUPS, gamma.to(dtype),
                                             beta.to(dtype), 1e-6)
            ms, call_ms, source = _timed(call, iters)
            kernels[part] = {
                "ms": ms, "call_ms": call_ms, "ms_source": source,
                "plain_ms": (_timed(ref, max(2, iters // 3))[0] if plain
                             else None),
                "library_ms": _timed(lib, iters)[0],
                "plan": gn.plan(shape, GN_GROUPS, dtype, backward)._asdict(),
                **_gn_bound(shape, dtype, backward)}
        case = {"shape": list(shape), "groups": GN_GROUPS,
                "dtype": str(dtype).split(".")[-1], "errors": errs,
                "kernels": kernels}
        cases.append(case)
        del xg, gg, bg, lib_out, x, dy
        torch.cuda.empty_cache()
        err_line = ", ".join(
            f"{n} {e['max_abs_err']:.3e}{' (bitwise)' if e['bitwise'] else ''}"
            for n, e in errs.items())
        log(f"[groupnorm] {tuple(shape)} G={GN_GROUPS} C/G={c // GN_GROUPS} "
            f"{case['dtype']}: {err_line}")
        for name, kk in kernels.items():
            p = kk["plan"]
            plain_txt = (f", plain {kk['plain_ms']:.4f} ms"
                         if kk["plain_ms"] is not None else "")
            log(f"[groupnorm]   {name}: kernel {kk['ms']:.4f} ms{plain_txt}, "
                f"F.group_norm {kk['library_ms']:.4f} ms ({kk['ms_source']};"
                f" with the host {kk['call_ms']:.4f} ms), bound "
                f"{kk['bound_ms']:.4f} ms ({kk['bound_by']}); plan "
                f"{p['path']}: {p['cols']} channels x {p['rows']} rows, "
                f"{p['tiles']} tiles, cluster {p['cluster']}, vec "
                f"{p['vec']}, {p['threads']} threads and {p['smem']} B "
                f"shared memory a CTA")
        assert ok, errs
    for d in ("fwd", "bwd"):
        assert any(c["kernels"][d]["plan"]["path"] == "stream"
                   for c in cases), f"no streaming case in {d}"
    return cases


# -- phase 14 ----------------------------------------------------------------

RESNET_B = 128


def _resnet_model(norm, dtype, seed):
    from distkeras_tpu_torch.models.resnet import init_params, resnet50

    return init_params(resnet50(dtype=dtype, norm=norm),
                       torch.Generator().manual_seed(seed))


def _image_batch(b, seed):
    """Seeded uint8 NHWC images and one-hot labels over 1000 classes."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    return {"features": x, "labels": y}


def _resnet_run(dev, norm, steps):
    """resnet50(norm) in bf16 with float32 parameters,
    categorical_crossentropy, adamw(1e-3), ``steps`` steps on one seeded
    batch: (losses, state, step, batch, info)."""
    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    model = _resnet_model(norm, torch.bfloat16, seed=0)
    tx = optimizers.get("adamw", 1e-3)
    state = engine.create_train_state(model, tx, device=dev)
    step = engine.make_train_step(model, "categorical_crossentropy", tx,
                                  metrics=("accuracy",))
    batch = engine.to_device(_image_batch(RESNET_B, seed=1), dev)
    kernels = (gn.group_norm_fwd, gn.group_norm_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in kernels:
        kernel.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
    info = {"launches": {k.__name__: k.launches for k in kernels},
            "step_s": times,
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return losses, state, step, batch, info


def phase_resnet_train(dev, power_line) -> tuple:
    """Path B: resnet50() (GroupNorm) in bf16, batch 128 of seeded uint8
    224^2 images, adamw(1e-3): 1 warm-up and 4 timed steps, 53 GroupNorm
    forward and 53 backward launches a step."""
    losses, state, step, batch, run = _resnet_run(dev, "gn", 5)
    median_s = statistics.median(run["step_s"][1:])
    info = {"losses": losses, "step_s": run["step_s"],
            "median_step_s": median_s,
            "images_per_s": RESNET_B / median_s,
            "peak_bytes": run["peak_bytes"], "launches": run["launches"],
            "card": power_line, "card_after": smi_sample()}
    log(f"[resnet-train] resnet50() GroupNorm, batch {RESNET_B} x 224^2 "
        f"uint8, bf16 compute, f32 params, adamw(1e-3): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; median step "
        f"{median_s * 1e3:.1f} ms of 4 timed (warm-up "
        f"{run['step_s'][0] * 1e3:.1f} ms), {info['images_per_s']:.1f} "
        f"images/s, peak {run['peak_bytes'] / 2**30:.2f} GiB, GroupNorm "
        f"launches {run['launches']} [{power_line}; after: "
        f"{info['card_after']}]")
    assert all(math.isfinite(x) for x in losses), losses
    assert all(n == 53 * len(losses) for n in run["launches"].values()), run
    return info, (state, step, batch)


def phase_resnet_witness(dev, losses) -> dict:
    """The same steps with the GroupNorm kernels swapped for their plain
    versions (in this script only): steps 1-4 within 1e-3 relative."""
    from unittest import mock

    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    with mock.patch.object(gn, "group_norm_fwd",
                           gn.group_norm_fwd_reference), \
            mock.patch.object(gn, "group_norm_bwd",
                              gn.group_norm_bwd_reference):
        plain, *_ = _resnet_run(dev, "gn", len(losses))
    torch.cuda.empty_cache()
    diff = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    info = {"plain_losses": plain, "kernel_losses": losses,
            "rel_diff": diff}
    log(f"[resnet-witness] plain GroupNorm: losses "
        f"{', '.join(f'{x:.5f}' for x in plain)} (kernels "
        f"{', '.join(f'{x:.5f}' for x in losses)}; relative differences "
        f"{', '.join(f'{x:.2e}' for x in diff)}, steps 1-4 bound 1e-3)")
    assert max(diff[:4]) <= 1e-3, info
    return info


def phase_resnet_identity(dev) -> dict:
    """float32 with TF32 off in matmuls AND cuDNN convolutions, and
    cuDNN's deterministic algorithms (its float32 backward otherwise sums
    in an order that changes from run to run, which is not what this
    compares): resnet50() at b=2, its norm scales and biases drawn at
    random (so that no branch is hidden behind a zero-init scale), the
    GroupNorm kernels against their plain versions in the loss, every
    gradient, and the parameters after one SGD step."""
    import copy
    from unittest import mock

    from distkeras_tpu_torch import engine
    from distkeras_tpu_torch.ops import optimizers
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    set_tf32(False)
    model = _resnet_model("gn", torch.float32, seed=7)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, gn.GroupNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape,
                                                       generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    models = {"kernel": model.to(dev), "plain": copy.deepcopy(model).to(dev)}
    batch = engine.to_device(_image_batch(2, seed=9), dev)
    plain_gn = (mock.patch.object(gn, "group_norm_fwd",
                                  gn.group_norm_fwd_reference),
                mock.patch.object(gn, "group_norm_bwd",
                                  gn.group_norm_bwd_reference))
    tx = optimizers.get("sgd", 0.1)
    got = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for name, m in models.items():
        patches = plain_gn if name == "plain" else ()
        for p in patches:
            p.start()
        try:
            (loss, _), grads = engine.make_grad_fn(
                m, "categorical_crossentropy")(batch)
            got[name] = (loss.item(), grads)
            state = engine.create_train_state(m, tx, device=dev)
            engine.make_train_step(m, "categorical_crossentropy", tx)(
                state, batch)
        finally:
            for p in patches:
                p.stop()
    torch.backends.cudnn.deterministic = deterministic
    loss_rel = abs(got["kernel"][0] - got["plain"][0]) / abs(got["plain"][0])
    grad_rel = {n: ((g - got["plain"][1][n]).norm()
                    / got["plain"][1][n].norm().clamp(min=1e-30)).item()
                for n, g in got["kernel"][1].items()}
    param_err = max((a - b).abs().max().item() for a, b in zip(
        models["kernel"].parameters(), models["plain"].parameters()))
    worst = max(grad_rel, key=grad_rel.get)
    info = {"loss_kernel": got["kernel"][0], "loss_plain": got["plain"][0],
            "loss_rel": loss_rel, "max_grad_rel": grad_rel[worst],
            "worst_grad": worst, "sgd_param_max_abs_err": param_err,
            "tf32": [torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32]}
    log(f"[resnet-identity] f32 (TF32 off: matmul, cuDNN; deterministic "
        f"cuDNN) resnet50() b=2, "
        f"GroupNorm kernels vs plain: loss {got['kernel'][0]:.6f} vs "
        f"{got['plain'][0]:.6f} (rel {loss_rel:.2e}, bound 1e-5), worst "
        f"grad rel {grad_rel[worst]:.2e} ({worst}, bound 1e-4), params "
        f"after one SGD step {param_err:.2e} (bound 1e-6)")
    assert not any(info["tf32"])
    assert loss_rel <= 1e-5 and grad_rel[worst] <= 1e-4 \
        and param_err <= 1e-6, info
    del models, model
    torch.cuda.empty_cache()
    return info


def phase_nf(dev, power_line) -> dict:
    """The NF recipe's first card run: resnet50_nf() in bf16, batch 128,
    2 adamw steps; finite losses and the step time (no kernel of the
    port runs: Scaled-WS convolutions on cuDNN)."""
    losses, _, _, _, run = _resnet_run(dev, "nf", 2)
    info = {"losses": losses, "step_s": run["step_s"],
            "peak_bytes": run["peak_bytes"], "card": power_line}
    log(f"[nf] resnet50_nf() bf16 batch {RESNET_B}: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in run['step_s'])} ms (the "
        f"first includes warm-up), peak {run['peak_bytes'] / 2**30:.2f} GiB")
    assert all(math.isfinite(x) for x in losses), losses
    assert all(n == 0 for n in run["launches"].values()), run
    torch.cuda.empty_cache()
    return info


# -- phases 16-18 -------------------------------------------------------------

def phase_rect(dev, power_line) -> dict:
    """The engine's default pool (``page_size=None``: one full-context
    row a slot, plain attention over it) on phase 4's traffic, a traced
    run for its busy share, and phase 5's float32 greedy check."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    info = _engine_run(dev, model, power_line, "rect")
    assert info["launches"] == 0 and info["compiles"] == 6, info
    with GenerationEngine(model, device=dev, **ENGINE_KW) as eng:
        info["profile"] = _traced_serve(eng, "rect-profile")
    assert info["profile"]["paged_kernels_traced"] == 0, info["profile"]
    del model
    torch.cuda.empty_cache()
    info["greedy"] = phase_greedy(dev, tag="rect-greedy", page_size=None)
    return info


def phase_sampled(dev) -> dict:
    """``sampling=True, temperature=0.7`` in bf16 on both pools: two
    engines fed the same requests in the same order give the same
    streams, another seed another stream, every token in the vocabulary."""
    from distkeras_tpu_torch.serving import GenerationEngine

    model = _gpt_small_bf16()
    prompts = _serving_prompts()[:4]
    info = {}
    for pool, page_size in (("paged", PAGE), ("rect", None)):
        streams = []
        for seed in (321, 321, 322):
            with GenerationEngine(model, device=dev, page_size=page_size,
                                  sampling=True, temperature=0.7,
                                  seed=seed, **ENGINE_KW) as eng:
                streams.append([f.result(timeout=600).tokens.tolist()
                                for f in [eng.generate(p, max_new_tokens=16)
                                          for p in prompts]])
        assert streams[0] == streams[1], (pool, streams[:2])
        assert streams[0] != streams[2], pool
        assert all(0 <= t < model.vocab_size for s in streams for r in s
                   for t in r)
        info[pool] = {"seed_321": streams[0], "seed_322": streams[2]}
        log(f"[sampled] {pool}: seed 321 twice gives the same "
            f"{sum(map(len, streams[0]))} tokens, seed 322 another stream")
    del model
    torch.cuda.empty_cache()
    return info


def phase_chunked(dev, power_line) -> dict:
    """Chunked prefill on the paged pool: phase 5's float32 greedy check
    with ``prefill_chunk=16`` (the 40-token prompt in three chunks, at
    cursors 0, 16 and 32; the chunk shares the 16-token bucket's graph),
    then phase 4's traffic in bf16 with ``prefill_chunk=32`` (the
    32-token bucket's graph)."""
    info = {"greedy": phase_greedy(dev, tag="chunked-greedy",
                                   page_size=PAGE, prefill_chunk=16)}
    model = _gpt_small_bf16()
    info.update(_engine_run(dev, model, power_line, "chunked",
                            page_size=PAGE, prefill_chunk=32))
    assert info["compiled_executables"]["prefill_chunk"] == (32,)
    assert info["compiles"] == 6, info["compiled_executables"]
    assert info["launches"] == model.num_layers * info["model_calls"] > 0
    del model
    torch.cuda.empty_cache()
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
        report["int8_cases"] = phase_int8_kernel(dev)
        report["int8_train"], int8_run = phase_int8_train(dev, card)
        report["int8_train_profile"] = phase_train_profile(
            *int8_run, tag="int8-profile")
        assert report["int8_train_profile"]["int8_kernel_launches"] == 48
        del int8_run
        torch.cuda.empty_cache()
        report["int8_witness"] = phase_int8_witness(
            dev, report["int8_train"]["losses"])
        report["gn_cases"] = phase_gn_kernels(dev)
        report["resnet_train"], resnet_run = phase_resnet_train(dev, card)
        report["resnet_train_profile"] = phase_train_profile(
            *resnet_run, tag="resnet-profile")
        del resnet_run
        torch.cuda.empty_cache()
        report["resnet_witness"] = phase_resnet_witness(
            dev, report["resnet_train"]["losses"])
        report["resnet_identity"] = phase_resnet_identity(dev)
        report["nf"] = phase_nf(dev, card)
        report["rect"] = phase_rect(dev, card)
        report["sampled"] = phase_sampled(dev)
        report["chunked"] = phase_chunked(dev, card)
    except Exception:  # any phase failing fails the run
        traceback.print_exc()
        log("[chip_smoke] FAILED")
        return 1
    main_case = next(c for c in report["kernel_cases"]
                     if (c["b"], c["t"], c["h"], c["d"], c["max_len"],
                         c["dtype"]) == (8, 2, H, D, PMAX * PAGE,
                                         "bfloat16"))
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
            "split_terms": kk["split_terms"],
            "ms_source": kk["ms_source"],
            "shape": "b=8 t=2048 h=12 d=64 causal bf16",
        })
    qkv = next(c for c in report["int8_cases"] if c["name"] == "qkv")
    rows.append({
        "name": "int8_matmul_dequant", "route": "cuda",
        "source": "distkeras_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
        "replaces": "distkeras_tpu/ops/pallas/int8_matmul.py:68",
        "launches": report["int8_train"]["launches"]["int8_matmul_dequant"],
        "max_abs_err": max(c["max_abs_err"] for c in report["int8_cases"]),
        "ms": qkv["ms"], "plain_ms": qkv["plain_ms"],
        "bound_ms": qkv["bound_ms"], "bound_by": qkv["bound_by"],
        "library_ms": qkv["library_ms"], "ms_source": qkv["ms_source"],
        "x_bound": qkv["x_bound"],
        "shape": "qkv: int8 [16384, 768] x [2304, 768] -> bf16",
    })
    stem = next(c for c in report["gn_cases"]
                if c["shape"] == [128, 12544, 64]
                and c["dtype"] == "bfloat16")
    for name, part, outs, line in (
            ("group_norm_fwd", "fwd", ("y", "stats"), 60),
            ("group_norm_bwd", "bwd", ("dx", "dgamma_p", "dbeta_p"), 87)):
        kk = stem["kernels"][part]
        rows.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/ops/kernels/csrc/groupnorm.cu",
            "replaces": f"distkeras_tpu/ops/pallas/groupnorm.py:{line}",
            "launches": report["resnet_train"]["launches"][name],
            "max_abs_err": max(stem["errors"][o]["max_abs_err"]
                               for o in outs),
            "ms": kk["ms"], "plain_ms": kk["plain_ms"],
            "bound_ms": kk["bound_ms"], "bound_by": kk["bound_by"],
            "library_ms": kk["library_ms"], "ms_source": kk["ms_source"],
            "shape": "ResNet-50 stem [128, 12544, 64] G=32 bf16",
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
