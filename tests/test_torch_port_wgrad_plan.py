"""The plan of K10's weight-gradient kernel (csrc/conv3d_wgrad.cu) on the
CPU: `wgrad_plan` at every (b, r, ci, co) whose weight gradient the stage-1
step (batch 32) and the two-prior step (batch 40) take, and at edge shapes,
in fp32 and bf16. The slabs cover every (item, brick) pair once, the plan
reads nothing of the card (so the sums' order is the same on any card),
the partials' scratch stays under its cap, the shared memory fits, and the
plan's constants are the source's. The kernel's walk of a plan is in
tests/test_torch_port_wgrad_walk.py; the kernel runs on the card in
tests/test_torch_port_gpu.py.
"""
import math
import re
from pathlib import Path

import pytest
import torch

from lion_tpu_torch.ops import conv3d
from lion_tpu_torch.ops.conv3d import (SMEM_BYTES, WGRAD_BLOCKS,
                                       WGRAD_BRICK, WGRAD_SCRATCH,
                                       WGRAD_THREADS, _WGRAD_TILES,
                                       wgrad_plan)
from lion_tpu_torch.profile_step import WGRAD_STEPS

from test_torch_port_sample import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
CSRC = Path(conv3d.__file__).resolve().parents[1] / "csrc"
# (b, r, ci, co) of the weight gradients of the stage-1 VAE step (batch 32)
# and the two-prior step (batch 40)
MAIN = sorted({k for calls in WGRAD_STEPS.values() for k in calls})
EDGE = [(2, 5, 4, 32), (1, 8, 7, 9), (3, 6, 16, 70), (2, 2, 3, 4),
        (1, 16, 96, 192), (2, 32, 192, 3), (64, 32, 64, 64)]


def _slabs(p):
    return [range(s * p.per_slab, min((s + 1) * p.per_slab, p.pairs))
            for s in range(p.slabs)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,r,ci,co", MAIN + EDGE)
def test_wgrad_plan_covers_every_pair_once_and_fits(b, r, ci, co, dtype):
    p = wgrad_plan(b, r, ci, co, dtype)
    assert (p.kc, p.bn) in _WGRAD_TILES
    lanes = p.kc * p.bn // 4
    assert lanes % 32 == 0 and p.streams * lanes == WGRAD_THREADS
    tiles = -(-ci // p.kc) * (-(-co // p.bn))
    assert p.grid == (tiles, p.slabs)
    assert p.pairs == b * math.prod(-(-r // s) for s in WGRAD_BRICK)
    # every (item, brick) pair in exactly one slab, in order, none empty
    slabs = _slabs(p)
    assert [q for s in slabs for q in s] == list(range(p.pairs))
    assert all(len(s) > 0 for s in slabs)
    # at most WGRAD_BLOCKS blocks where a block per slab allows it
    assert tiles * p.slabs <= max(WGRAD_BLOCKS, tiles)
    # the partials: one (27, ci, co) f32 a slab, under the cap
    assert p.scratch == p.slabs * 27 * ci * co * 4 <= max(
        WGRAD_SCRATCH, 27 * ci * co * 4)
    # shared memory: two staging buffers (the halo brick of kc channels and
    # the brick's g of bn), or the streams' merge, whichever is larger
    esize = 2 if dtype == BF16 else 4
    cells = math.prod(s + 2 for s in WGRAD_BRICK)
    staging = 2 * esize * (cells * p.kc + math.prod(WGRAD_BRICK) * p.bn)
    merge = 4 * (p.streams - 1) * 108 * lanes
    assert p.smem == max(staging, merge) <= SMEM_BYTES


@pytest.mark.parametrize("b,r,ci,co", MAIN)
def test_wgrad_plan_is_the_same_whatever_the_card(b, r, ci, co, monkeypatch):
    """The slabs fix the order of dw's sums: the plan depends on the shape
    alone, not on the SM count the brick convs' plans read, nor on
    anything the card reports."""
    want = wgrad_plan.__wrapped__(b, r, ci, co, F32)

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    for sms in (66, 114, 132, 264):
        monkeypatch.setattr(conv3d, "SMS", sms)
        assert wgrad_plan.__wrapped__(b, r, ci, co, F32) == want


@pytest.mark.parametrize("r,ci,co,tile", [
    (32, 64, 64, (16, 64)), (16, 128, 128, (16, 64)),
    (8, 192, 128, (16, 64)), (16, 128, 64, (16, 64)),
    (32, 32, 32, (32, 32)), (16, 32, 32, (32, 32)),
    (32, 4, 32, (4, 32)), (32, 3, 32, (4, 32)), (8, 8, 32, (8, 32))])
def test_wgrad_plan_picks_the_tile_that_wastes_least(r, ci, co, tile):
    """No padded channels at the main-path shapes (C3 pads to 4), then the
    fewest staged elements a product: 16 x 64 over 32 x 32 where both fit."""
    p = wgrad_plan(32, r, ci, co, F32)
    assert (p.kc, p.bn) == tile


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+)",
                         (CSRC / "conv3d_wgrad.cu").read_text()).group(1))


def test_wgrad_plan_constants_are_the_sources():
    src = (CSRC / "conv3d_wgrad.cu").read_text()
    assert re.search(r"constexpr int kBd = (\d+), kBh = (\d+), kBw = (\d+);",
                     src).groups() == tuple(map(str, WGRAD_BRICK))
    assert _constant("kThreads") == WGRAD_THREADS
    compiled = re.findall(r"case (\d+) \* 1024 \+ (\d+): return go", src)
    assert sorted((int(a), int(b)) for a, b in compiled) == sorted(
        _WGRAD_TILES)
