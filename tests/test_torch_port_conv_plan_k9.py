"""K9's cluster and the statistics' merge of the halo-brick convolutions
(csrc/pvblock.cu, csrc/conv_brick.cuh) on the CPU: K9's 8 blocks per item
are the plan of its shape, a PyTorch walk of its cluster (4 bricks x 2
channel tiles per item, per-block voxelize, statistics summed in rank
order, per-block devoxelize) against its plain version, the fixed-order
merge of the statistics (per-warp slots, one partial per block, the last
block's fixed tree) on every main-path K4 and K8 plan, and K9's voxelize
order (integer counts, a one-warp scan, warps placing their points in
turn). The brick walks these build on are in
tests/test_torch_port_conv_plan.py.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.conv3d import (SMEM_SM, _conv3d_3x3_fused_plain,
                                       conv_plan)
from lion_tpu_torch.ops.pvblock import _pvconv_block_pair_plain
from lion_tpu_torch.ops.voxel import _trilinear_devoxelize_plain
from lion_tpu_torch.profile_step import K4_CASES

from test_torch_port_conv_plan import (BF16, F32, _assert_bf16_close,
                                       _assert_fp32_close, _bf16, _fold,
                                       _pair_inputs, _walk)

from test_torch_port_sample import one_torch_thread  # noqa: F401


def _pvblock_constants():
    """K9's compile-time tile (csrc/pvblock.cu)."""
    src = (Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
           / "pvblock.cu").read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_pvblock_cluster_is_the_plan_of_its_shape():
    """K9's 8 blocks per item are conv_plan's grid for (b, 8, 128, 128,
    bf16): 4 bricks of 2 x 8 x 8 voxels (d-major) by 2 tiles of 64 output
    channels, with the plan's chunk. Its weight stage is the plan's rule at
    two blocks per SM (so that 16 clusters of 8 fit the card at once): the
    most taps whose buffers, beside the kernel's 768 floats of statistics
    and fold, fit twice in an SM."""
    k = _pvblock_constants()
    kc, bn, static = k["kKc"], k["kBn"], 4 * (2 * 2 * k["kBn"] + 4 * k["kC"])
    cells = (k["kPlanes"] + 2) * (k["kR"] + 2) ** 2
    for b in (1, 2, 16):
        p = conv_plan(b, k["kR"], k["kC"], k["kC"], BF16)
        assert p.brick == (k["kPlanes"], k["kR"], k["kR"]) and p.tile == 1
        assert (p.bn, p.kc) == (bn, kc)
        assert p.grid == (k["kR"] // k["kPlanes"], k["kC"] // bn, b)
        assert p.grid[0] * p.grid[1] == k["kCluster"]

    def fits_twice(taps):
        smem = 2 * (2 * cells * kc + 2 * taps * kc * bn) + 4 * cells
        return 2 * (smem + static + 1024) <= SMEM_SM
    assert k["kBlocksPerSm"] == 2
    assert fits_twice(k["kTaps"]) and 27 % k["kTaps"] == 0
    assert not any(fits_twice(t) for t in (27, 9) if t > k["kTaps"])


def _block_walk(feats, vox, nc, w0, b0, ca, cb, w1, rounded):
    """K9 block by block: rank = 2 pp + half owns planes [2 pp, 2 pp + 2)
    and channels [64 half, 64 half + 64). Each voxelizes its cells and
    channels; each conv is the plan's walk with every block's partial
    statistics kept, the item's statistics summed over pp in rank order;
    rank q devoxelizes points [q N / 8, (q + 1) N / 8)."""
    b, n, c = feats.shape
    r = 8
    p = conv_plan(b, r, c, c, BF16)
    npp, bn = p.grid[0], p.bn
    cells = p.brick[0] * r * r
    flat = ((vox[..., 0] * r + vox[..., 1]) * r + vox[..., 2]).long()
    grid = torch.full((b, r ** 3, c), float("nan"))
    for item in range(b):
        for pp in range(npp):
            local = flat[item] - pp * cells
            mine = (local >= 0) & (local < cells)
            for half in range(p.grid[1]):
                ch = slice(half * bn, (half + 1) * bn)
                sums = torch.zeros(cells, bn).index_add_(
                    0, local[mine], feats[item, mine, ch].float())
                count = torch.zeros(cells).index_add_(
                    0, local[mine], torch.ones(int(mine.sum())))
                mean = sums / count.clamp(min=1.0)[:, None]
                grid[item, pp * cells:(pp + 1) * cells, ch] = \
                    _bf16(mean) if rounded else mean
    grid = grid.reshape(b, r, r, r, c)

    def rank_order(parts):
        st = torch.zeros(b, 2, c)
        for item in range(b):
            for half in range(p.grid[1]):
                acc = torch.zeros(2, bn)
                for pp in range(npp):
                    acc = acc + parts[pp, half, item]
                st[item, :, half * bn:(half + 1) * bn] = acc
        return st
    parts0, parts1 = {}, {}
    y0, _ = _walk(grid, w0, None, None, False, p, rounded, parts0)
    sc, bi = _fold(rank_order(parts0), b0, ca, cb, float(r ** 3))
    y1, _ = _walk(y0, w1, sc, bi, True, p, rounded, parts1)
    if rounded:
        y1 = y1.to(BF16)
    per = n // (npp * p.grid[1])
    pts = torch.cat([_trilinear_devoxelize_plain(
        y1, nc[:, q * per:(q + 1) * per].contiguous(), r)
        for q in range(npp * p.grid[1])], 1)
    return pts, rank_order(parts1)


@pytest.mark.parametrize("n", [64, 256, 2048])
def test_pvblock_walk_matches_the_block_plain_version(n):
    b, r, c = 2, 8, 128
    rs = np.random.RandomState(n)
    nc = torch.from_numpy(rs.uniform(0, r - 1, (b, n, 3)).astype(np.float32))
    nc[:, :8] = torch.round(nc[:, :8])    # points on cells: frac = 0
    vox = torch.round(nc).to(torch.int32)
    feats = torch.from_numpy(rs.randn(b, n, c).astype(np.float32))
    _, w0, b0, ca, cb, w1 = _pair_inputs(b, r, c, seed=n + 1)
    _assert_fp32_close(
        _block_walk(feats, vox, nc, w0, b0, ca, cb, w1, rounded=False),
        _pvconv_block_pair_plain(feats, vox, nc, w0, b0, ca, cb, w1, r))
    feats, w0, w1 = (_bf16(t) for t in (feats, w0, w1))
    got = _block_walk(feats, vox, nc, w0, b0, ca, cb, w1, rounded=True)
    ref = _pvconv_block_pair_plain(feats.to(BF16), vox, nc, w0.to(BF16), b0,
                                   ca, cb, w1.to(BF16), r)
    assert got[0].dtype == ref[0].dtype == BF16
    _assert_bf16_close(got, ref)


# ------------------------------------------------- the statistics' merge
def _tile_slots():
    """The tiles' statistics slots (csrc/conv_brick.cuh: kSlots of the bf16
    tile, then of the fp32 tile), 2 bn floats each."""
    src = (Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
           / "conv_brick.cuh").read_text()
    bf, f32 = (int(v) for v in re.findall(
        r"static constexpr int kSlots = (\d+);", src))
    return {BF16: bf, F32: f32}


STAT_SLOTS = _tile_slots()
# (r, ci, co, dtype) of every K4 call of the local steps (profile_step's
# cases) and of K8's two convs (r32 C64 bf16)
STAT_CASES = sorted({(r, ci, co, dt) for r, ci, co, dt, _ in K4_CASES}
                    | {(32, 64, 64, BF16)}, key=str)


def _merged_stats(y, p, dtype):
    """flush_stats's sums of y (B, r, r, r, co): each block's slots (the
    tile's kSlots equal runs of its brick's voxels in d-major order: a
    warpgroup's planes in bf16, a warp's voxel runs in fp32) summed in
    slot order into the block's partial; then, per (item, channel tile),
    thread (value, slice) sums bricks slice, slice + slices, ... in order
    and the slices are summed in order."""
    b, r, co = y.shape[0], y.shape[1], y.shape[-1]
    nb = [-(-r // s) for s in p.brick]
    bd, bh, bw = p.brick
    slots = STAT_SLOTS[dtype]
    yf = y.float()
    part = torch.zeros(b, p.grid[0], 2, co)
    for bx in range(p.grid[0]):
        iw, ih, idd = bx % nb[2], (bx // nb[2]) % nb[1], bx // nb[2] // nb[1]
        v = yf[:, idd * bd:(idd + 1) * bd, ih * bh:(ih + 1) * bh,
               iw * bw:(iw + 1) * bw].reshape(b, -1, co)
        runs = v.reshape(b, slots, -1, co)
        acc = torch.zeros(b, 2, co)
        for j in range(slots):
            acc = acc + torch.stack([runs[:, j].sum(1),
                                     (runs[:, j] * runs[:, j]).sum(1)], 1)
        part[:, bx] = acc
    slices = p.threads // (2 * p.bn)
    sl = torch.zeros(slices, b, 2, co)
    for k in range(slices):
        for j in range(k, p.grid[0], slices):
            sl[k] = sl[k] + part[:, j]
    out = torch.zeros(b, 2, co)
    for k in range(slices):
        out = out + sl[k]
    return out


@pytest.mark.parametrize("r,ci,co,dtype", STAT_CASES)
def test_statistics_merge_fits_and_equals_the_plain_statistics(r, ci, co,
                                                               dtype):
    b = 2
    p = conv_plan(b, r, ci, co, dtype)
    assert all(r % s == 0 for s in p.brick)   # whole bricks on the main path
    slot_bytes = STAT_SLOTS[dtype] * 2 * p.bn * 4
    # the slots and then the merge's scratch (a float a thread) reuse the
    # staging buffers; the threads split into whole slices of 2 bn values
    assert p.threads * 4 <= slot_bytes <= p.smem
    assert p.threads % (2 * p.bn) == 0
    # each slot's run is whole: a warpgroup's planes (bf16), a warp's 32
    # threads' runs of `tile` voxels (fp32)
    voxels = math.prod(p.brick)
    if dtype == BF16:
        assert voxels // 2 == (p.brick[0] // 2) * 64
    else:
        assert voxels // 8 == 32 // (p.bn // 8) * p.tile
    rs = np.random.RandomState(r + ci + co)
    x = torch.from_numpy(rs.randn(b, r, r, r, ci).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rs.randn(3, 3, 3, ci, co) * (27 * ci) ** -0.5)
                         .astype(np.float32)).to(dtype)
    y, st = _conv3d_3x3_fused_plain(x, w)
    got = _merged_stats(y, p, dtype)
    # fp32 sums of up to 32768 values in another order (the GPU tests'
    # tolerance of the fp32 kernel's statistics)
    torch.testing.assert_close(got, st, rtol=1e-4,
                               atol=1e-4 * float(st.abs().max()))


def _k9_vox_order(cells, k_cells, threads=256):
    """K9's voxelize order for one block: integer counts of its k_cells
    cells, the exclusive scan of one warp whose lane l owns cells
    [4 l, 4 l + 4), and the placement in rounds of `threads` points whose
    warps take turns: a lane goes to its cell's cursor (read before its
    warp's leaders move it) plus its rank among its warp's earlier lanes of
    the same cell."""
    counts = np.bincount(cells[cells >= 0], minlength=k_cells)
    per_lane = counts.reshape(32, 4)
    inc = np.cumsum(per_lane.sum(1))
    start = np.zeros(k_cells + 1, np.int64)
    for lane in range(32):
        at = inc[lane] - per_lane[lane].sum()
        for j in range(4):
            start[4 * lane + j] = at
            at += per_lane[lane, j]
    start[k_cells] = inc[-1]
    cursor = start[:-1].copy()
    order = np.full(len(cells), -1, np.int64)
    for i0 in range(0, len(cells), threads):
        for w0 in range(i0, min(i0 + threads, len(cells)), 32):
            lanes = cells[w0:w0 + 32]
            at = cursor.copy()
            for lane, cell in enumerate(lanes):
                if cell >= 0:
                    order[at[cell] + np.sum(lanes[:lane] == cell)] = w0 + lane
            for cell in np.unique(lanes[lanes >= 0]):
                cursor[cell] += np.sum(lanes == cell)
    return start, order[:start[-1]]


@pytest.mark.parametrize("n", [64, 256, 2048, 4096])
def test_pvblock_voxelize_order_gives_the_point_order_means(n):
    """Each of K9's plane pairs orders the points of its 128 cells stably,
    and the (cell, channel) sums taken in that order over the count are the
    float32 sums in point order (np.add.at), bit for bit: the plain
    version's voxelize."""
    k = _pvblock_constants()
    r, k_cells = k["kR"], k["kPlanes"] * k["kR"] * k["kR"]
    rs = np.random.RandomState(n + 3)
    vox = np.round(rs.uniform(0, r - 1, (n, 3)) ** 1.5 / (r - 1) ** 0.5)
    vox = vox.astype(np.int64)
    vox[::9] = [r, 0, 0]                        # outside the grid
    feats = torch.from_numpy(rs.randn(n, 16).astype(np.float32)).to(BF16)
    f = feats.float().numpy()
    flat = (vox[:, 0] * r + vox[:, 1]) * r + vox[:, 2]
    inside = np.all((vox >= 0) & (vox < r), axis=1)
    for pp in range(r // k["kPlanes"]):
        local = np.where(inside, flat - pp * k_cells, -1)
        cells = np.where((local >= 0) & (local < k_cells), local, -1)
        start, order = _k9_vox_order(cells, k_cells)
        keep = np.nonzero(cells >= 0)[0]
        np.testing.assert_array_equal(
            order, keep[np.argsort(cells[keep], kind="stable")])
        got = np.zeros((k_cells, f.shape[1]), np.float32)
        for c in range(k_cells):
            acc = np.zeros(f.shape[1], np.float32)
            for j in order[start[c]:start[c + 1]]:
                acc = acc + f[j]
            if start[c + 1] > start[c]:
                got[c] = acc / np.float32(start[c + 1] - start[c])
        sums = np.zeros((k_cells, f.shape[1]), np.float32)
        np.add.at(sums, cells[keep], f[keep])
        count = np.bincount(cells[keep], minlength=k_cells)[:, None]
        want = np.where(count > 0, sums / np.maximum(count, 1)
                        .astype(np.float32), np.float32(0))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
