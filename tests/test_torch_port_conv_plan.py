"""The plan of the halo-brick convolutions (K4 and K10, csrc/conv_brick.cuh)
on the CPU: `conv_plan` at every main-path and GPU-edge shape, and a PyTorch
walk of each plan's bricks, with the kernel's index and halo logic, against
the plain versions.

The kernel itself runs only on the card (tests/test_torch_port_gpu.py); this
file holds what surrounds it: the grid covers every output voxel and channel
once, the shared memory fits, and the halo cells, the tap offsets, the
chunks of input channels and the output-channel tiles put every product in
its place.
"""
import math

import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.conv3d import (SMEM_BYTES, SMEM_SM, _BF16_TILES,
                                       _FP32_TILES,
                                       _conv3d_3x3_fused_plain,
                                       _conv3d_3x3_same_plain, conv_plan)

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
    assert p.smem + 8 * p.bn <= SMEM_BYTES
    assert p.min_blocks * (p.smem + 8 * p.bn + 1024) <= SMEM_SM
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


def _walk(x, w, scale, shift, swish, p):
    """y = conv3d_SAME(pro(x), w) and its statistics, computed brick by
    brick as the kernel computes them (float32): block (bx, by, item)
    gathers each chunk's halo brick by the kernel's cell decode, applies the
    prologue to the in-grid cells only, leaves the halo and the channels
    past ci at 0, and adds the 27 taps as row offsets into the brick."""
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
                    halo[inside, :n] = vals
                    for t, off in enumerate(taps):
                        acc += halo[rows + off] @ wp[t, c0:c0 + p.kc,
                                                     n0:n0 + p.bn]
                m = min(p.bn, co - n0)
                got = acc[out, :m]
                y[item, od[out], oh[out], ow[out], n0:n0 + m] = got
                stats[item, 0, n0:n0 + m] += got.sum(0)
                stats[item, 1, n0:n0 + m] += (got * got).sum(0)
    return y, stats


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
