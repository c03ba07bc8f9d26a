"""The port's benchmark runners on the CPU (``--device cpu``), and that
without a card and without ``--device cpu`` they refuse instead of
measuring the host.

- ``python -m distkeras_tpu_torch.benchmarks``: configs 1-5 run their
  smoke shapes through the port's trainers and print one JSON line each
  (config 5 through ``PjitTrainer``);
- ``bench_torch.py --tiny --device cpu`` prints one JSON line with
  ``bench.py``'s keys; without a card and without ``--device cpu`` it
  exits non-zero and prints no result.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.benchmarks import run_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _lines(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_configs_one_to_three_run_on_the_cpu_when_asked(capsys):
    assert run_config.main(["all", "--device", "cpu"]) == 0
    lines = {d["config"]: d for d in _lines(capsys.readouterr().out)}
    assert sorted(lines) == ["1", "2", "3", "4", "5"]
    for k, name in (("1", "mnist-mlp-adag"), ("2", "cifar-cnn-downpour"),
                    ("3", "resnet50-aeasgd"), ("4", "bert-dynsgd"),
                    ("5", "vit-pjit")):
        d = lines[k]
        assert d["name"] == name and d["mode"] == "smoke"
        assert d["device"] == "cpu" and d["steps"] > 0
        assert d["samples_per_sec"] > 0 and "mfu" not in d
    # config 4 at its smoke shape: 512 rows of 32 int16 ids, batch 16, one
    # epoch on one worker
    assert lines["4"]["steps"] == 512 // 16
    assert 0 < lines["4"]["final_loss"] < 10
    # config 5 at its smoke shape: 512 rows of 16x16 images, batch 64, one
    # epoch on one worker
    assert "error" not in lines["5"] and lines["5"]["steps"] == 512 // 64
    assert np.isfinite(lines["5"]["final_loss"])


def test_runners_refuse_the_host_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run_config.main(["1"]) == 1
    (line,) = _lines(capsys.readouterr().out)
    assert "error" in line and "device='cpu'" in line["error"]
    with pytest.raises(SystemExit):
        run_config.main(["1", "--full", "--device", "cpu"])


def test_bench_torch_tiny_cpu_line(capsys):
    assert bench_torch.main(["--tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    last = json.loads(out[-1])
    assert BENCH_KEYS <= set(last)
    assert last["metric"] == "resnet50_adag_samples_per_sec_per_chip"
    assert last["value"] > 0 and last["vs_baseline"] is None
    assert last["device"] == "cpu" and "mfu" not in last
    assert sum(line.startswith("{") for line in out) == 1


def test_bench_torch_without_a_card_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_torch.main([]) == 1
    assert bench_torch.main(["--tiny"]) == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        bench_torch.main(["--device", "cpu"])  # the full size on the host
