"""The port's ``profiling`` package against the JAX package's, on the CPU.

- ``classify``, ``fix_tag`` and ``build_report`` give the JAX package's
  rows, digest and shares on the same hand-built ``OpCost`` lists (both
  kernel registries emptied, so only the classification is compared);
- ``op_inventory``'s FLOPs total equals ``count_flops`` on the same call,
  and its source view equals it on the CPU (no kernel launches there):
  coverage 1;
- ``capture_op_times`` declines on the CPU (``available=False``) and
  counts that once; the HBM table by (monkeypatched) device name.
"""

import numpy as np
import pytest
import torch

from distkeras_tpu.profiling import cost_model as jcost
from distkeras_tpu.profiling import roofline as jroof
from distkeras_tpu_torch import engine, observability, telemetry
from distkeras_tpu_torch.models.gpt import gpt_tiny
from distkeras_tpu_torch.profiling import (OpCost, OpInventory, build_report,
                                           capture_op_times, classify,
                                           device_hbm_bandwidth,
                                           op_inventory, source_inventory)
from distkeras_tpu_torch.profiling import capture, roofline

PEAK, BW = 989e12, 3.35e12

#: (name, opcode, flops, bytes, source, fusion_ops): compute- and
#: memory-bound products, a fusion, an attention group, a collective, a
#: latency-bound op, and two rows of one source (grouped)
ROWS = [
    ("dot.1", "dot", 4e12, 1e9, "layers_0/dense", ()),
    ("dot.2", "dot", 1e9, 4e9, "layers_0/dense", ()),
    ("fusion.3", "fusion", 2e12, 2e8, "block/conv", ("convolution", "add")),
    ("fusion.4", "fusion", 1e11, 1e9, "attn/bhqk", ("dot", "exp")),
    ("all-reduce.5", "all-reduce", 1e6, 3e8, "", ()),
    ("add.6", "add", 10.0, 40.0, "tiny", ()),
    ("reduce.7", "reduce", 1e9, 6e9, "softmax", ()),
]


def _lists():
    j = [jcost.OpCost(name=n, opcode=o, flops=f, bytes_accessed=b,
                      output_bytes=b / 2, source=s, fusion_ops=fo)
         for n, o, f, b, s, fo in ROWS]
    t = [OpCost(name=n, opcode=o, flops=f, bytes_accessed=b,
                output_bytes=b / 2, source=s, fusion_ops=fo)
         for n, o, f, b, s, fo in ROWS]
    return j, t


@pytest.mark.parametrize("flops,bytes_", [(4e12, 1e9), (1e9, 4e9),
                                          (10.0, 40.0), (1e9, 0.0)])
def test_classify_equals_jax(flops, bytes_):
    assert classify(flops, bytes_, PEAK, BW) == \
        jroof.classify(flops, bytes_, PEAK, BW)


def test_fix_tags_equal_jax():
    j, t = _lists()
    for jr, tr in zip(j, t):
        for bound in ("compute", "memory", "latency"):
            assert roofline.fix_tag(tr, bound) == jroof.fix_tag(jr, bound)


@pytest.mark.parametrize("measured", [None, {"dot.1": 5e-3,
                                             "reduce.7": 1e-3}])
def test_build_report_rows_equal_jax(monkeypatch, measured):
    monkeypatch.setattr(jroof, "fix_registry", lambda: {})
    monkeypatch.setattr(roofline, "fix_registry", lambda: {})
    j, t = _lists()
    kw = dict(peak_flops=PEAK, hbm_bandwidth=BW, measured=measured,
              modeled_flops=8e12, top_k=5)
    want = jroof.build_report(jcost.OpInventory(rows=j), **kw)
    got = build_report(OpInventory(rows=t), **kw)
    assert [r.to_row() for r in got.rows] == [r.to_row() for r in want.rows]
    assert [r.op for r in got.top()] == [r.op for r in want.top()]
    assert got.digest() == want.digest()
    assert got.coverage == pytest.approx(want.coverage, rel=1e-12)
    assert got.measured_share == pytest.approx(want.measured_share,
                                               rel=1e-12)
    assert got.total_time_s == pytest.approx(want.total_time_s, rel=1e-12)
    assert "roofline vs bf16" in got.render()


def test_build_report_declines_without_ceilings():
    _, t = _lists()
    if not torch.cuda.is_available():
        assert not build_report(OpInventory(rows=t)).available
    empty = build_report(OpInventory(available=False, note="x"),
                         peak_flops=PEAK, hbm_bandwidth=BW)
    assert not empty.available and empty.digest()["note"] == "x"


def test_report_publishes_gauges_and_the_recorder_digest(monkeypatch):
    _, t = _lists()
    report = build_report(OpInventory(rows=t), peak_flops=PEAK,
                          hbm_bandwidth=BW, modeled_flops=8e12)

    class Recorder:
        digest = None

        def set_roofline(self, digest):
            Recorder.digest = digest

    monkeypatch.setattr(telemetry, "get_recorder", lambda: Recorder())
    report.publish()
    assert Recorder.digest == report.digest()
    gauges = telemetry.get_registry().snapshot()["gauges"]
    assert "profile.op.coverage" in gauges


def test_measured_time_of_a_shared_name_splits_over_its_rows():
    rows = [OpCost(name="aten::mm", opcode="mm", flops=1e9,
                   bytes_accessed=1e6, output_bytes=5e5, source=f"l{i}")
            for i in range(4)]
    report = build_report(OpInventory(rows=rows), peak_flops=PEAK,
                          hbm_bandwidth=BW, measured={"aten::mm": 4e-3})
    assert [r.est_time_s for r in report.rows] == pytest.approx([1e-3] * 4)
    assert report.measured_share == 1.0


def _gpt_step():
    torch.manual_seed(0)
    model = gpt_tiny(attention="flash")
    rng = np.random.default_rng(0)
    x = rng.integers(1, 256, (2, 128))
    batch = engine.to_device({"features": x, "labels": np.concatenate(
        [x[:, 1:], np.full((2, 1), -1)], axis=1)}, "cpu")
    grad = engine.make_grad_fn(model, "masked_lm")
    return lambda: grad(batch)


def test_op_inventory_totals_equal_count_flops_and_coverage_is_one():
    step = _gpt_step()
    inventory = op_inventory(step)
    source = source_inventory(step)
    assert inventory.available and source.available
    assert inventory.total_flops == observability.count_flops(step) > 0
    assert source.total_flops == inventory.total_flops
    assert not any(r.opcode == "kernel" for r in inventory.rows)
    assert any(r.source.startswith("CausalLM.layers") for r in
               inventory.rows)
    assert inventory.total_bytes > 0
    assert inventory.by_source()[0].flops >= inventory.by_source()[-1].flops
    report = build_report(inventory, peak_flops=PEAK, hbm_bandwidth=BW,
                          modeled_flops=source.total_flops)
    assert report.coverage == 1.0


def test_inventory_never_raises(monkeypatch):
    monkeypatch.setattr(
        __import__("distkeras_tpu_torch.profiling.cost_model",
                   fromlist=["x"]), "_inventory_noted", False)
    counter = telemetry.counter("profile.op.inventory_unavailable")
    before = counter.value

    def boom():
        raise RuntimeError("no")

    for _ in range(2):
        out = op_inventory(boom)
        assert not out.available and "RuntimeError" in out.note
    assert counter.value == before + 1


def test_capture_declines_on_the_cpu_and_counts_once(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the capture measures it")
    monkeypatch.setattr(capture, "_capture_noted", False)
    counter = telemetry.counter("profile.op.capture_unavailable")
    before = counter.value
    ran = []
    for _ in range(2):
        table = capture_op_times(lambda: ran.append(1), steps=2)
        assert not table.available and "CUDA" in table.note
        assert table.busy_share is None and table.seconds == {}
    assert ran == []  # nothing was run, so nothing measured the CPU
    assert counter.value == before + 1


@pytest.mark.parametrize("name,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                     ("NVIDIA H100 PCIe", 2.0e12),
                                     ("NVIDIA H100 NVL", 3.9e12),
                                     ("Tesla V100-SXM2-16GB", None)])
def test_hbm_lookup_by_device_name(monkeypatch, name, bw):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert device_hbm_bandwidth("cuda:0") == bw
    assert device_hbm_bandwidth("cpu") is None
