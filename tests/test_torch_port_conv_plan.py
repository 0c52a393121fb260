"""The plan of the halo-brick convolutions (K4, K8, K9 and K10,
csrc/conv_brick.cuh) on the CPU: `conv_plan` at every main-path and GPU-edge
shape, and a PyTorch walk of each plan's bricks, with the kernel's index and
halo logic, against the plain versions: K4 and K10 alone, K8's two brick
convs with the fold between them, and K9's cluster of 4 bricks x 2 channel
tiles per item with its per-block voxelize, statistics and devoxelize.
The statistics' fixed-order merge (per-warp slots, one partial per block,
the last block's fixed tree) is modelled on every main-path K4 and K8 plan,
and K9's voxelize order (integer counts, a one-warp scan, warps placing
their points in turn) is walked per block.

The kernel itself runs only on the card (tests/test_torch_port_gpu.py); this
file holds what surrounds it: the grid covers every output voxel and channel
once, the shared memory fits, and the halo cells, the tap offsets, the
chunks of input channels and the output-channel tiles put every product in
its place.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.conv3d import (GN_EPS, GN_GROUPS, SMEM_BYTES,
                                       SMEM_STATIC,
                                       SMEM_SM, _BF16_TILES, _FP32_TILES,
                                       _conv3d_3x3_fused_plain,
                                       _conv3d_pair_plain,
                                       _conv3d_3x3_same_plain, conv_plan)
from lion_tpu_torch.ops.pvblock import _pvconv_block_pair_plain
from lion_tpu_torch.ops.voxel import _trilinear_devoxelize_plain
from lion_tpu_torch.profile_step import K4_CASES

BF16, F32 = torch.bfloat16, torch.float32
# (b, r, ci, co): the local step's K4 / K10 shapes at batch 16 and the GPU
# edge tests' shapes at batch 2
MAIN = [(16, 32, 4, 32), (16, 32, 32, 32), (16, 16, 64, 64),
        (16, 16, 128, 64), (16, 16, 128, 128), (16, 8, 192, 128),
        (16, 8, 128, 128), (16, 32, 64, 64), (16, 32, 32, 4)]
EDGE = [(2, r, ci, co) for r, ci, co in [
    (5, 4, 32), (8, 192, 128), (16, 128, 64), (4, 7, 9), (3, 16, 70),
    (32, 4, 32), (32, 32, 32), (5, 12, 24), (2, 3, 4), (7, 12, 24),
    (2, 96, 192), (32, 192, 3), (16, 4, 96)]]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,r,ci,co", MAIN + EDGE)
def test_plan_covers_the_output_once_and_fits(b, r, ci, co, dtype):
    p = conv_plan(b, r, ci, co, dtype)
    vec = 8 if dtype == BF16 else 4
    assert (p.bn, p.tile) in (_BF16_TILES if dtype == BF16 else _FP32_TILES)
    assert p.threads == 256
    if dtype == BF16:   # planes of 8 x 8 voxels, the wgmma's N
        assert p.brick == (2 * p.tile, 8, 8)
        assert p.hpitch == p.kc and p.wpitch == p.bn
    else:               # a thread's run of voxels stays on one w row
        assert math.prod(p.brick) == p.tile * 2048 // p.bn
        assert p.brick[2] % p.tile == 0 and p.wpitch == p.bn
        assert (p.hpitch // vec) % 2 == 1 and p.hpitch >= p.kc
    # shared memory: the kernel's halo and weight buffers and its cell table
    esize = 2 if dtype == BF16 else 4
    chunks = -(-ci // p.kc)
    cells = math.prod(s + 2 for s in p.brick)
    assert p.smem == esize * (min(2, chunks) * cells * p.hpitch + min(
        2, chunks * 27 // p.taps) * p.taps * p.kc * p.wpitch) + 4 * cells
    assert p.smem + SMEM_STATIC <= SMEM_BYTES
    assert p.min_blocks * (p.smem + SMEM_STATIC + 1024) <= SMEM_SM
    if p.min_blocks == 2:   # one chunk, at most 64 accumulators a thread
        assert dtype == BF16 and chunks == 1 and p.tile <= 2
    # fragment depth, 16-byte rows, index shifts
    assert p.kc % (16 if dtype == BF16 else 4) == 0 and 27 % p.taps == 0
    assert p.kc & (p.kc - 1) == 0
    assert p.ldw >= co and p.ldw % vec == 0
    # every (item, voxel, channel) exactly once
    nb = [-(-r // s) for s in p.brick]
    assert p.grid == (math.prod(nb), -(-co // p.bn), b)
    count = np.zeros((r, r, r, co), np.int64)
    for bx in range(p.grid[0]):
        iw, ih, idd = bx % nb[2], (bx // nb[2]) % nb[1], bx // nb[2] // nb[1]
        for by in range(p.grid[1]):
            count[idd * p.brick[0]:(idd + 1) * p.brick[0],
                  ih * p.brick[1]:(ih + 1) * p.brick[1],
                  iw * p.brick[2]:(iw + 1) * p.brick[2],
                  by * p.bn:(by + 1) * p.bn] += 1
    assert (count == 1).all()


def _walk(x, w, scale, shift, swish, p, rounded=False, parts=None):
    """y = conv3d_SAME(pro(x), w) and its statistics, computed brick by
    brick as the kernel computes them (float32): block (bx, by, item)
    gathers each chunk's halo brick by the kernel's cell decode, applies the
    prologue to the in-grid cells only, leaves the halo and the channels
    past ci at 0, and adds the 27 taps as row offsets into the brick.
    `rounded`: the bf16 kernel's roundings (the prologue's output and y to
    bf16, the statistics of the rounded y). `parts`: a dict that receives
    each block's partial (sum, sumsq) of its channels, (2, m)."""
    b, r = x.shape[:2]
    ci, co = w.shape[3], w.shape[4]
    bd, bh, bw = p.brick
    nbh, nbw = -(-r // bh), -(-r // bw)
    hh, hw = bh + 2, bw + 2
    cells = (bd + 2) * hh * hw
    cell = torch.arange(cells)
    cd, ch_, cw = cell // hw // hh, cell // hw % hh, cell % hw
    v = torch.arange(bd * bh * bw)
    vd, vh, vw = v // bw // bh, v // bw % bh, v % bw
    rows = (vd * hh + vh) * hw + vw                       # Brick::row_of
    taps = [((t // 9) * hh + (t // 3) % 3) * hw + t % 3 for t in range(27)]
    wp = torch.zeros(27, -(-ci // p.kc) * p.kc, p.grid[1] * p.bn)
    wp[:, :ci, :co] = w.reshape(27, ci, co)
    y = torch.full((b, r, r, r, co), float("nan"))
    stats = torch.zeros(b, 2, co)
    for bx in range(p.grid[0]):
        d0, h0 = bx // nbw // nbh * bd, bx // nbw % nbh * bh
        w0 = bx % nbw * bw
        gd, gh, gw = d0 - 1 + cd, h0 - 1 + ch_, w0 - 1 + cw
        inside = ((gd >= 0) & (gd < r) & (gh >= 0) & (gh < r) & (gw >= 0)
                  & (gw < r))
        od, oh, ow = d0 + vd, h0 + vh, w0 + vw
        out = (od < r) & (oh < r) & (ow < r)
        for by in range(p.grid[1]):
            n0 = by * p.bn
            for item in range(b):
                acc = torch.zeros(len(v), p.bn)
                for c0 in range(0, ci, p.kc):
                    n = min(p.kc, ci - c0)
                    halo = torch.zeros(cells, p.kc)
                    vals = x[item, gd[inside], gh[inside], gw[inside],
                             c0:c0 + n]
                    if scale is not None:
                        vals = vals * scale[item, c0:c0 + n] \
                            + shift[item, c0:c0 + n]
                    if swish:
                        vals = vals * torch.sigmoid(vals)
                    if rounded and (scale is not None or swish):
                        vals = _bf16(vals)
                    halo[inside, :n] = vals
                    for t, off in enumerate(taps):
                        acc += halo[rows + off] @ wp[t, c0:c0 + p.kc,
                                                     n0:n0 + p.bn]
                m = min(p.bn, co - n0)
                got = _bf16(acc[out, :m]) if rounded else acc[out, :m]
                y[item, od[out], oh[out], ow[out], n0:n0 + m] = got
                part = torch.stack([got.sum(0), (got * got).sum(0)])
                stats[item, :, n0:n0 + m] += part
                if parts is not None:
                    parts[bx, by, item] = part
    return y, stats


def _bf16(t):
    return t.to(BF16).float()


# (plan dtype, b, r, ci, co): partial bricks, several chunks and output
# tiles, Ci below the fragment depth and Co off any multiple of 8
WALKS = [(F32, 2, 5, 12, 24), (F32, 2, 7, 4, 9), (F32, 1, 16, 128, 64),
         (F32, 2, 9, 20, 70), (F32, 1, 8, 192, 128), (F32, 2, 3, 3, 4),
         (BF16, 2, 5, 12, 24), (BF16, 2, 3, 16, 70), (BF16, 1, 16, 64, 64),
         (BF16, 1, 8, 128, 128), (BF16, 2, 4, 7, 9), (BF16, 1, 9, 40, 96)]


def _inputs(b, r, ci, co, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(b, r, r, r, ci).astype(np.float32))
    w = torch.from_numpy((rs.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci))
                         .astype(np.float32))
    scale = torch.from_numpy(1.0 + 0.1 * rs.randn(b, ci).astype(np.float32))
    # a large shift: pro(0) = swish(~3) != 0, so a prologue over the halo
    # would show
    shift = torch.from_numpy(3.0 + 0.1 * rs.randn(b, ci).astype(np.float32))
    return x, w, scale, shift


@pytest.mark.parametrize("dtype,b,r,ci,co", WALKS)
def test_brick_walk_matches_the_fused_plain_version(dtype, b, r, ci, co):
    x, w, scale, shift = _inputs(b, r, ci, co, seed=r * 1000 + ci + co)
    p = conv_plan(b, r, ci, co, dtype)
    y, st = _walk(x, w, scale, shift, True, p)
    yr, sr = _conv3d_3x3_fused_plain(x, w, scale, shift, pre_swish=True)
    # fp32 sums of 27 * ci terms in another order, held to 1e-5 of their size
    torch.testing.assert_close(y, yr, rtol=1e-5,
                               atol=1e-5 * float(yr.abs().max()))
    torch.testing.assert_close(st, sr, rtol=1e-5,
                               atol=1e-5 * float(sr.abs().max()))


@pytest.mark.parametrize("dtype,b,r,ci,co", WALKS[:6:2] + WALKS[6:9])
def test_brick_walk_matches_the_same_conv(dtype, b, r, ci, co):
    """K10's form: no prologue, and dx's flipped, transposed weights."""
    x, w, _, _ = _inputs(b, r, ci, co, seed=ci * co)
    p = conv_plan(b, r, ci, co, dtype)
    y, _ = _walk(x, w, None, None, False, p)
    yr = _conv3d_3x3_same_plain(x, w)
    torch.testing.assert_close(y, yr, rtol=1e-5,
                               atol=1e-5 * float(yr.abs().max()))
    g = torch.from_numpy(np.random.RandomState(1).randn(b, r, r, r, co)
                         .astype(np.float32))
    wt = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    dx, _ = _walk(g, wt, None, None, False, conv_plan(b, r, co, ci, dtype))
    dxr = _conv3d_3x3_same_plain(g, wt)
    torch.testing.assert_close(dx, dxr, rtol=1e-5,
                               atol=1e-5 * float(dxr.abs().max()))


# ------------------------------------------------- K8 and K9 (the pair)
def _fold(st, b0, ca, cb, count):
    """conv_brick.cuh: fold_gn, channel by channel as the kernel folds:
    per-channel moments with the pre-bias b0, their means over each group
    of C / 8 channels, var clamped at 0, (sc, bi)."""
    s1, s2 = st[:, 0], st[:, 1]
    m1 = s1 / count
    mu_c = m1 + b0
    ex2_c = s2 / count + 2.0 * b0 * m1 + b0 * b0
    b, c = s1.shape
    mu = mu_c.reshape(b, GN_GROUPS, -1).mean(2).repeat_interleave(
        c // GN_GROUPS, 1)
    ex2 = ex2_c.reshape(b, GN_GROUPS, -1).mean(2).repeat_interleave(
        c // GN_GROUPS, 1)
    rs = torch.rsqrt(torch.clamp_min(ex2 - mu * mu, 0.0) + GN_EPS)
    return rs * ca, (b0 - mu) * rs * ca + cb


def _pair_walk(x, w0, b0, ca, cb, w1, rounded):
    """K8: conv0 on the pair's plan, the fold of its statistics, conv1 with
    the fold and swish as its prologue on the same plan."""
    b, r, c = x.shape[0], x.shape[1], x.shape[-1]
    p = conv_plan(b, r, c, c, BF16)
    y0, st0 = _walk(x, w0, None, None, False, p, rounded)
    sc, bi = _fold(st0, b0, ca, cb, float(r ** 3))
    return _walk(y0, w1, sc, bi, True, p, rounded)


def _pair_inputs(b, r, c, seed):
    rs = np.random.RandomState(seed)
    t = lambda *shape, s=1.0: torch.from_numpy(   # noqa: E731
        (s * rs.randn(*shape)).astype(np.float32))
    return (t(b, r, r, r, c), t(3, 3, 3, c, c, s=(27 * c) ** -0.5),
            t(c, s=0.1), 1.0 + t(b, c, s=0.1), t(b, c, s=0.1),
            t(3, 3, 3, c, c, s=(27 * c) ** -0.5))


def _assert_bf16_close(got, ref, rel=2e-2):
    """chip_smoke.py's _bf16_close(2e-2): bf16 outputs whose float32 sums
    were taken in another order land a rounding one bf16 ulp (2^-8) apart
    here and there, and GroupNorm carries a flip on; every output is held
    to 2e-2 of its size."""
    for g, r in zip(got, ref):
        scale = float(r.float().abs().max())
        torch.testing.assert_close(g.float(), r.float(), rtol=rel,
                                   atol=rel * scale)


def _assert_fp32_close(got, ref):
    """fp32 sums of 27 * C terms in another order: 1e-5 of the size."""
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("b,r,c", [(1, 32, 64), (2, 8, 128), (2, 4, 8),
                                   (2, 5, 24)])
def test_pair_walk_matches_the_pair_plain_version(b, r, c):
    args = _pair_inputs(b, r, c, seed=r * 100 + c)
    # both convs' blocks: the plan's buffers and the statistics
    p = conv_plan(b, r, c, c, BF16)
    assert p.smem + SMEM_STATIC <= SMEM_BYTES
    assert p.min_blocks * (p.smem + SMEM_STATIC + 1024) <= SMEM_SM
    _assert_fp32_close(_pair_walk(*args, rounded=False),
                       _conv3d_pair_plain(*args))
    x, w0, b0, ca, cb, w1 = args
    x, w0, w1 = (_bf16(t) for t in (x, w0, w1))
    got = _pair_walk(x, w0, b0, ca, cb, w1, rounded=True)
    ref = _conv3d_pair_plain(x.to(BF16), w0.to(BF16), b0, ca, cb,
                             w1.to(BF16))
    _assert_bf16_close(got, ref)


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
