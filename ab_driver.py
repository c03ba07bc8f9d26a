"""The shared driver of ``groupnorm_ab.py``, ``int8_ab.py`` and
``serving_ab.py``: run one function of this checkout and of another
checkout, each in a process of its own, in the order other, this, this,
other, on one card.

A script hands :func:`main` its ``run_tree(tree, args) -> dict`` (what one
checkout measures, run in the child process) and its ``report(runs,
args) -> (ok, payload)`` (the rows it prints from the four runs, a failed
run being ``None``). :func:`main` parses ``--other`` and the script's own
flags, starts the children, writes ``{device, other, **payload}`` as
``<script>.json`` into ``chip_smoke.OUT_DIR`` and returns 0 when every
child ran and ``report`` said ok, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = ("other", "this", "this", "other")


def use_tree(tree) -> None:
    """Make ``import distkeras_tpu_torch`` (and ``chip_smoke``) load the
    checkout at ``tree`` from here on. Modules already imported keep the
    objects they bound."""
    sys.path.insert(0, os.path.abspath(tree))
    for name in [m for m in sys.modules
                 if m == "chip_smoke" or m.startswith("distkeras_tpu_torch")]:
        del sys.modules[name]


def main(script, run_tree, report, argv=None, add_args=None) -> int:
    """Drive ``script`` (its ``__file__``) as the module docstring says.
    ``add_args(parser)`` declares the script's own flags, which the
    children get too."""
    name = os.path.splitext(os.path.basename(script))[0]
    doc = sys.modules["__main__"].__doc__ or name
    parser = argparse.ArgumentParser(
        description=" ".join(doc.split("\n\n")[0].split()))
    parser.add_argument("--other", required=True,
                        help="root of another checkout of this repo")
    if add_args is not None:
        add_args(parser)
    parser.add_argument("--run-tree", help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}.py needs a CUDA card")
    if args.run_tree:
        with open(args.out, "w") as f:
            json.dump(run_tree(args.run_tree, args), f, default=str)
        return 0

    own = list(sys.argv[1:] if argv is None else argv)
    trees = {"other": args.other, "this": HERE}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, which in enumerate(ORDER):
            out = os.path.join(tmp, f"{k}.json")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(script), *own,
                 "--run-tree", trees[which], "--out", out], cwd=HERE)
            if proc.returncode != 0:
                runs.append(None)
                continue
            with open(out) as f:
                runs.append(json.load(f))
    ok, payload = report(runs, args)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, f"{name}.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "other": args.other, **payload}, f, indent=1,
                  default=str)
    return 0 if ok and all(run is not None for run in runs) else 1
