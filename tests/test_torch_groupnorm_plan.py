"""The GroupNorm kernels' planner (``groupnorm.plan``), a pure function of
the shape, groups, dtype and direction that the CPU can check: every
GroupNorm input of the ResNets at 224^2 and batch 128 takes the cluster
path, larger slabs stream, and no shape with G dividing C is refused.
The plans are also held to the rules the C entry validates
(csrc/groupnorm.cu ``valid``). No JAX: the shapes come from walking the
port's models on the meta device.
"""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import resnet
from distkeras_tpu_torch.ops.kernels import groupnorm as tg
from distkeras_tpu_torch.ops.kernels._build import SMEM_OPTIN_BYTES

DTYPES = [torch.bfloat16, torch.float32]


def _resnet_norm_shapes(name, b=128, side=224):
    """The ``[B, HW, C]`` and groups of every GroupNorm call of one
    forward of ``resnet.<name>()`` on ``b`` images of ``side``^2, walked
    on the meta device (no memory, no arithmetic)."""
    seen = []

    def record(self, x):
        seen.append(((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1]),
                     self.num_groups))
        return x

    with torch.device("meta"), mock.patch.object(tg.GroupNorm, "forward",
                                                 record):
        getattr(resnet, name)()(torch.zeros(b, side, side, 3,
                                            dtype=torch.uint8))
    return seen


def _assert_valid(shape, groups, dtype, backward, p):
    """The rules of csrc/groupnorm.cu ``valid`` and ``layout``."""
    b, hw, c = shape
    item = torch.finfo(dtype).bits // 8
    cg = c // groups
    assert c % p.cols == 0 and (p.cols % cg == 0 or cg % p.cols == 0), p
    assert p.vec * item <= 16 and p.cols % p.vec == 0 and c % p.vec == 0, p
    assert p.cols // p.vec <= p.threads <= 256 and p.threads % 32 == 0, p
    assert p.rows >= 1 and p.tiles == -(-hw // p.rows), p
    if p.path == "cluster":
        assert p.cluster == p.tiles <= tg.MAX_CLUSTER and p.cols >= cg, p
        assert tg.workspace_doubles(shape, groups, p, backward) == 0
    else:
        assert p.path == "stream" and p.cluster == 1, p
        assert tg.workspace_doubles(shape, groups, p, backward) > 0
    assert p.smem == tg.smem_bytes(p.rows, p.cols, p.vec, item, cg,
                                   backward, p.threads) <= SMEM_OPTIN_BYTES, p
    assert b * (c // p.cols) * p.tiles < 2 ** 31


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["resnet18", "resnet34", "resnet50",
                                  "resnet101"])
def test_every_resnet_group_norm_takes_the_cluster_path(name, dtype,
                                                        backward):
    """At 224^2 and b=128 each norm's (sample, column block) fits one
    cluster of at most 16 CTAs, each within its tier's shared memory
    (TILE_BYTES for CTA_THREADS threads, else two CTAs an SM), in column
    blocks of whole groups at least 64 bytes wide."""
    shapes = _resnet_norm_shapes(name)
    assert len(shapes) == {"resnet18": 20, "resnet34": 36, "resnet50": 53,
                           "resnet101": 104}[name]
    item = torch.finfo(dtype).bits // 8
    for shape, groups in sorted(set(shapes)):
        p = tg.plan(shape, groups, dtype, backward)
        _assert_valid(shape, groups, dtype, backward, p)
        assert p.path == "cluster", (shape, p)
        assert p.smem <= (tg.TILE_BYTES if p.threads == tg.CTA_THREADS
                          else tg._BIG_TILE_BYTES), (shape, p)
        assert p.cols * item >= 64 and p.cols % (shape[2] // groups) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet50_stem_plan(dtype):
    """The stem [128, 12544, 64] (1.6 MB a sample in bf16): the preferred
    128-byte column block does not fit 16 CTAs of TILE_BYTES, so it
    halves to 64 bytes, 837 rows a CTA over clusters of 15; the backward
    (x and dy) needs the larger CTAs for that."""
    fwd = tg.plan((128, 12544, 64), 32, dtype)
    bwd = tg.plan((128, 12544, 64), 32, dtype, backward=True)
    cols = 32 if dtype == torch.bfloat16 else 16
    assert (fwd.cols, bwd.cols) == (cols, cols)
    assert (fwd.threads, bwd.threads) == (tg.CTA_THREADS,
                                          tg._BIG_CTA_THREADS)
    assert fwd.cluster == bwd.cluster == 15 and fwd.rows == bwd.rows == 837


def test_512_stem_streams():
    """A 512^2 stem in float32 (16.8 MB a sample) outgrows a cluster's
    shared memory even at a 64-byte column block: both directions take
    the streaming path."""
    for backward in (False, True):
        p = tg.plan((2, 65536, 64), 32, torch.float32, backward)
        _assert_valid((2, 65536, 64), 32, torch.float32, backward, p)
        assert p.path == "stream", p


def test_plan_of_the_slab_the_old_gate_refused():
    """[1, 60000, 64] float32, refused before (a (sample, group) slab
    above 227 KiB), streams in 128-byte column blocks: 373 rows a tile
    forward, 184 backward (x and dy), within STREAM_TILE_BYTES."""
    shape = (1, 60000, 64)
    assert tg.fits(shape, 32, torch.float32)
    assert tg.plan(shape, 32, torch.float32) == tg.Plan(
        "stream", 32, 373, 161, 1, 4, 128, 49152)
    assert tg.plan(shape, 32, torch.float32, backward=True) == tg.Plan(
        "stream", 32, 184, 327, 1, 4, 128, 49024)


@pytest.mark.parametrize("dtype", DTYPES)
def test_group_wider_than_256_chunks_is_split(dtype):
    """One group of 4096 channels (512 or 1024 chunks a row, the old
    gate's other refusal): the streaming path splits it into column blocks
    of one chunk a thread and sums its partials across them."""
    shape = (2, 7, 8192)
    for backward in (False, True):
        p = tg.plan(shape, 2, dtype, backward)
        _assert_valid(shape, 2, dtype, backward, p)
        assert p.path == "stream" and p.cols < 4096 and 4096 % p.cols == 0
        assert p.cols // p.vec == p.threads


def test_no_shape_with_groups_dividing_channels_is_refused():
    """Seeded shapes of every kind (odd widths, one-value loads, huge
    groups, long rows): each has a valid plan in both dtypes and
    directions."""
    rng = np.random.default_rng(0)
    cases = [(1, 1, 1, 1), (3, 10, 24, 8), (2, 7, 48, 16), (2, 5, 6, 3),
             (1, 3, 9, 3), (2, 100, 512, 4), (1, 2, 4097, 17)]
    for _ in range(300):
        groups = int(rng.choice([1, 2, 3, 4, 8, 16, 32, 64]))
        c = groups * int(rng.integers(1, 300))
        hw = int(rng.choice([1, 7, 49, 196, 784, 3136, 12544, 50000,
                             int(rng.integers(1, 70000))]))
        cases.append((int(rng.integers(1, 9)), hw, c, groups))
    for b, hw, c, groups in cases:
        for dtype in DTYPES:
            for backward in (False, True):
                assert tg.fits((b, hw, c), groups, dtype)
                p = tg.plan((b, hw, c), groups, dtype, backward)
                _assert_valid((b, hw, c), groups, dtype, backward, p)


def test_fits_refuses_only_dtype_and_divisibility():
    assert tg.fits((128, 12544, 64), 32, torch.bfloat16)
    assert not tg.fits((2, 10, 24), 5, torch.float32)
    assert not tg.fits((2, 10, 24), 8, torch.float16)
    assert not tg.fits((10, 24), 8, torch.float32)
