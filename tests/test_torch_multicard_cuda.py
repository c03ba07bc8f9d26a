"""The cards of one host: every kernel on every card, and an NCCL pair.

Skipped on a host with fewer than two CUDA cards. This file imports no
JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_multicard_cuda.py

Each kernel of the table (the paged kernel, the three flash kernels, the
int8 product, GroupNorm forward and backward) runs on ``cuda:0`` and
then on every other card, each against its plain version on the same
inputs at ``chip_smoke.py`` phase 35 (a)'s bounds (``chip_smoke.card_rows``):
a kernel opts into its dynamic shared memory once a card, so a launch on
``cuda:1`` after ``cuda:0`` must opt in again.

Two ranks, on ``cuda:0`` and ``cuda:1``, join a two-process group
(``distributed.initialize`` with ``local_device_ids``, a 120 s collective
timeout; each child has a hard timeout and is killed in a ``finally``):
``fold_group`` must choose NCCL, and the fold, the all-gather (float32,
int32, and int16 and bool as bytes) and a hop with its backward on the
cards must give bit for bit what the same moves give on host tensors over
gloo.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
def test_every_kernel_row_matches_its_plain_version_on_every_card(cards):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    chip_smoke.set_tf32(False)
    for card in cards:  # cuda:0 first, then every other card
        rows = chip_smoke.card_rows(card)
        assert [r["name"] for r in rows] == [
            "paged_flash_attention", "flash_attention_fwd",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "int8_matmul_dequant", "group_norm_fwd", "group_norm_bwd"]
        bad = [r for r in rows if not r["ok"]]
        assert not bad, (str(card), bad)


PAIR_CHILD = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(0, sys.argv[4])
    from distkeras_tpu_torch.parallel import collectives, distributed
    distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank,
                           local_device_ids=[rank], timeout_s=120)
    dev = torch.device("cuda", rank)
    _, backend = distributed.fold_group(dev)
    rng = np.random.default_rng(rank)
    host = {"w": torch.from_numpy(rng.standard_normal((257, 33)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.standard_normal(1000).astype(
                np.float32)).to(torch.bfloat16),
            "n": torch.from_numpy(rng.integers(-9, 9, 77).astype(np.int32))}
    card = {k: v.to(dev) for k, v in host.items()}
    fold_h = collectives.cross_process_sum(host, bucket_bytes=4096)
    fold_c = collectives.cross_process_sum(card, bucket_bytes=4096)
    gathered = [host["w"], host["n"],
                torch.from_numpy(rng.integers(-999, 999, 50).astype(
                    np.int16)), torch.from_numpy(rng.random(31) < 0.5)]
    got_h = collectives.all_gather_flat(gathered)
    got_c = collectives.all_gather_flat([g.to(dev) for g in gathered])

    def hop(device):
        x = host["w"].clone().to(device).requires_grad_()
        w = torch.arange(257 * 33, dtype=torch.float32,
                         device=device).reshape(257, 33) * (rank + 1)
        _, (got,) = collectives.hop(
            [(x * 2, 1 - rank)],
            [(1 - rank, (257, 33), torch.float32, device)])
        (got * w).sum().backward()
        collectives.flush_hops()
        return got.detach().cpu(), x.grad.cpu()

    hop_h, hop_c = hop("cpu"), hop(dev)
    info = {
        "backend": backend,
        "fold": all(torch.equal(fold_h[k], fold_c[k].cpu()) for k in host),
        "gather": all(torch.equal(a, b.cpu()) and b.device == dev
                      for ra, rb in zip(got_h, got_c)
                      for a, b in zip(ra, rb)),
        "gather_dtypes": [str(t.dtype) for t in got_c[1 - rank]],
        "hop": all(torch.equal(a, b) for a, b in zip(hop_h, hop_c))}
    with open(os.path.join(out, f"pair.r{rank}.json"), "w") as f:
        json.dump(info, f)
    distributed.barrier()
    torch.distributed.destroy_process_group()
""")


@pytest.mark.cuda
def test_nccl_pair_moves_match_gloo_through_the_host(cards, tmp_path):
    script = tmp_path / "child.py"
    script.write_text(PAIR_CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), port, str(tmp_path), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for rank in (0, 1):
        info = json.loads((tmp_path / f"pair.r{rank}.json").read_text())
        assert info["backend"] == "nccl", info
        assert info["fold"] and info["gather"] and info["hop"], info
        assert info["gather_dtypes"] == ["torch.float32", "torch.int32",
                                         "torch.int16", "torch.bool"], info
