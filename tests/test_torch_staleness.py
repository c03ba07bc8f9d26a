"""The staleness-vs-wall-clock twin on the CPU, against the JAX
package's harness.

One module-scoped sweep (ADAG and AEASGD, windows 1 and 2, K = 4, both
modes, 512 training rows, 2 epochs) on ``device="cpu"``:

- the grid is covered, with JAX's JSON fields on every point;
- sync staleness is the rotation's closed form (mean (K-1)/2, max K-1)
  and equals a JAX sync point's staleness statistics, commit count and
  rounds (exactly);
- host_async records one staleness sample a commit, every window
  committed;
- the curves are epoch-boundary measurements and the held-out loss falls;
- ``derive`` equals JAX's on the same points;
- the command line exits 1 with no result without a card, and writes
  its JSON with ``--device cpu``.
"""

import copy
import json

import numpy as np
import pytest
import torch

from distkeras_tpu.benchmarks import staleness_tradeoff as jst
from distkeras_tpu_torch.benchmarks import staleness_tradeoff as st

FIELDS = ("strategy", "window", "num_workers", "mode", "epochs",
          "batch_size", "rounds_per_epoch", "commits", "staleness_mean",
          "staleness_p95", "staleness_max", "total_wall_s",
          "samples_per_sec", "final_heldout_loss", "curve",
          "time_to_target_s", "loss_at_budget")


@pytest.fixture(scope="module")
def result():
    return st.sweep(strategies=["adag", "aeasgd"], windows=[1, 2],
                    workers=[4], modes=["sync", "host_async"], n_train=512,
                    n_heldout=128, batch_size=16, epochs=2,
                    learning_rate=0.05, seed=0, device="cpu")


def test_sweep_covers_the_grid_with_jax_fields(result):
    pts = result["points"]
    assert len(pts) == 8
    combos = {(p["mode"], p["strategy"], p["window"], p["num_workers"])
              for p in pts}
    assert ("sync", "adag", 1, 4) in combos
    assert ("host_async", "aeasgd", 2, 4) in combos
    for p in pts:
        assert set(p) == set(FIELDS)
    assert set(result) == {"target_loss", "wall_budget_s", "points",
                           "protocol"}
    assert result["protocol"]["platform"] == "cpu"


def test_sync_staleness_is_the_closed_form_and_jax_s(result):
    for p in result["points"]:
        if p["mode"] != "sync":
            continue
        k = p["num_workers"]
        assert p["staleness_mean"] == pytest.approx((k - 1) / 2)
        assert p["staleness_max"] == k - 1
    from distkeras_tpu.data.dataset import Dataset, synthetic_mnist
    from distkeras_tpu.models.mlp import MLP as JMLP

    full = synthetic_mnist(n=640, seed=0)
    cols = {c: np.asarray(full[c]) for c in full.columns}
    train = Dataset({c: v[:512] for c, v in cols.items()})
    held = Dataset({c: v[512:] for c, v in cols.items()})
    jp = jst.run_point(strategy="adag", window=1, num_workers=4,
                       mode="sync", model=JMLP(features=(64,)),
                       train_ds=train, heldout=held, batch_size=16,
                       epochs=2)
    mine = next(p for p in result["points"]
                if (p["mode"], p["strategy"], p["window"]) ==
                ("sync", "adag", 1))
    for key in ("staleness_mean", "staleness_p95", "staleness_max",
                "commits", "rounds_per_epoch", "epochs"):
        assert mine[key] == jp[key], key


def test_host_async_staleness_is_recorded_per_commit(result):
    for p in result["points"]:
        if p["mode"] != "host_async":
            continue
        assert p["commits"] == p["epochs"] * p["rounds_per_epoch"] * \
            p["num_workers"]
        assert p["staleness_p95"] >= p["staleness_mean"] >= 0.0
        assert p["staleness_max"] <= 2 * p["commits"]


def test_curves_are_epoch_boundary_measurements(result):
    for p in result["points"]:
        curve = p["curve"]
        assert len(curve) == p["epochs"]
        walls = [c["wall_s"] for c in curve]
        assert walls == sorted(walls) and walls[0] > 0.0
        assert all(np.isfinite(c["heldout_loss"]) for c in curve)
        assert p["final_heldout_loss"] == curve[-1]["heldout_loss"]
        assert p["total_wall_s"] == pytest.approx(walls[-1])
        assert p["samples_per_sec"] > 0
    drops = [p["curve"][0]["heldout_loss"] - p["final_heldout_loss"]
             for p in result["points"]]
    assert max(drops) > 0.0


def test_derive_equals_jax(result):
    pts = [{k: p[k] for k in ("final_heldout_loss", "curve")}
           for p in result["points"]]
    for kw in ({}, {"target_loss": 2.2, "wall_budget": 0.05}):
        mine = st.derive(copy.deepcopy(pts), **kw)
        theirs = jst.derive(copy.deepcopy(pts), **kw)
        assert mine == theirs


def test_command_line_refuses_without_a_card_and_runs_on_cpu(
        tmp_path, monkeypatch, capsys):
    out = tmp_path / "s.json"
    args = ["--strategies", "dynsgd", "--windows", "2", "--workers", "2",
            "--n-train", "256", "--n-heldout", "64", "--epochs", "1",
            "--out", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert st.main(args) == 1
    assert not out.exists() and capsys.readouterr().out == ""
    assert st.main(args + ["--device", "cpu"]) == 0
    with open(out) as f:
        got = json.load(f)
    assert [p["mode"] for p in got["points"]] == ["sync", "host_async"]
