"""Time this checkout's GroupNorm kernels against another checkout's on one
card.

    python3 groupnorm_ab.py --other OLD [--iters 20]

``OLD`` is an unpacked earlier commit of this repo (``git archive``). At
one ResNet-50 b=128 norm of each C/G class (``chip_smoke.GN_CASES``) in
bf16 and float32, and at the streaming case (``GN_STREAM_CASE``, float32),
it times the forward and backward wrappers (``group_norm_fwd``,
``group_norm_bwd`` of ``distkeras_tpu_torch.ops.kernels.groupnorm``) of
each checkout in its own process, in the order other, this, this, other
(device ms a call, ``chip_smoke.device_ms``), and checks that both give
the same bits: y forward, dx and the per-sample partials backward, from
the same seeded inputs and statistics. A shape the other checkout refuses
is recorded as refused. Prints one JSON line a case and writes
``groupnorm_ab.json`` into ``chip_smoke.OUT_DIR``. Needs a CUDA card and
nvcc; each checkout builds its own kernels on first use.
"""

from __future__ import annotations

import hashlib
import json
import sys

import torch

import ab_driver
import chip_smoke


def _cases():
    runs = [(shape, dtype) for shape in chip_smoke.GN_CASES
            for dtype in ("bfloat16", "float32")]
    return runs + [(chip_smoke.GN_STREAM_CASE, "float32")]


def _stats(x, groups, eps=1e-6):
    """Float32 ``[B, 2, G]`` mean and rstd of ``x`` for the backward's
    input, computed here so that both checkouts get the same bits."""
    b, hw, c = x.shape
    xg = x.double().reshape(b, hw, groups, c // groups)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 3))
    rstd = (var + eps).rsqrt()
    return torch.stack([mu.reshape(b, groups), rstd], dim=1).float()


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def run_tree(tree, args) -> list:
    """The GroupNorm wrappers of the checkout at ``tree``, at every case
    on the card: device ms a call and a digest of the outputs, forward
    and backward."""
    ab_driver.use_tree(tree)
    from distkeras_tpu_torch.ops.kernels import groupnorm as gn

    dev, iters = torch.device("cuda:0"), args.iters
    rows = []
    for shape, dtype_name in _cases():
        dtype = getattr(torch, dtype_name)
        b, hw, c = shape
        gen = torch.Generator(device=dev).manual_seed(hw + c)
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev)
        x, dy = mk(*shape).to(dtype), mk(*shape).to(dtype)
        gamma, beta = 1.0 + 0.1 * mk(c), 0.1 * mk(c)
        groups = chip_smoke.GN_GROUPS
        stats = _stats(x, groups)
        calls = {
            "fwd": lambda i: gn.group_norm_fwd(x, gamma, beta, groups)[:1],
            "bwd": lambda i: gn.group_norm_bwd(x, gamma, stats, dy, groups)}
        row = {"shape": list(shape), "dtype": dtype_name}
        for part, call in calls.items():
            try:
                out = call(0)
            except ValueError as e:
                row[part] = {"refused": str(e)}
                continue
            row[part] = {"ms": chip_smoke.device_ms(call, iters),
                         "digest": _digest(out)}
        rows.append(row)
        del x, dy, stats
        torch.cuda.empty_cache()
    return rows


def report(runs, args) -> tuple:
    """One row a case; ok when both checkouts give the same bits."""
    card = chip_smoke.smi_sample()
    rows, same = [], True
    for i, (shape, dtype_name) in enumerate(_cases()):
        row = {"shape": list(shape), "dtype": dtype_name, "card": card}
        for part in ("fwd", "bwd"):
            got = [run[i][part] if run else {} for run in runs]
            timed = [g for g in got if "ms" in g]
            digests = {g["digest"] for g in timed}
            row[part] = {
                "other_this_this_other_ms": [g.get("ms") for g in got],
                "other_refused": any("refused" in g for g in got[::3]),
                "same_bits": len(digests) == 1,
                **chip_smoke._gn_bound(shape, getattr(torch, dtype_name),
                                       part == "bwd")}
            same &= len(digests) == 1 and all("ms" in g for g in got[1:3])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return same, {"rows": rows}


def _iters(parser) -> None:
    parser.add_argument("--iters", type=int, default=20)


if __name__ == "__main__":
    sys.exit(ab_driver.main(__file__, run_tree, report, add_args=_iters))
