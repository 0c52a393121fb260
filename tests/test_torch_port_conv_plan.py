"""The plan of the halo-brick convolutions (K4, K8, K9 and K10,
csrc/conv_brick.cuh) on the CPU: `conv_plan` at every main-path and GPU-edge
shape, and a PyTorch walk of each plan's bricks, with the kernel's index and
halo logic, against the plain versions: K4 and K10 alone and K8's two brick
convs with the fold between them. K9's cluster and the statistics' merge
are walked in tests/test_torch_port_conv_plan_k9.py.

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

from lion_tpu_torch.ops.conv3d import (GN_EPS, GN_GROUPS, SMEM_BYTES,
                                       SMEM_STATIC,
                                       SMEM_SM, _BF16_TILES, _FP32_TILES,
                                       _conv3d_3x3_fused_plain,
                                       _conv3d_pair_plain,
                                       _conv3d_3x3_same_plain, conv_plan)
from lion_tpu_torch.profile_step import (STAGE1_K10_CASES,
                                         STAGE1_K10_DX)

from test_torch_port_sample import one_torch_thread  # noqa: F401

BF16, F32 = torch.bfloat16, torch.float32
# (b, r, ci, co): the local step's K4 / K10 shapes at batch 16, the stage-1
# step's K10 shapes (forward and dx) at the released batch 32 and the GPU
# edge tests' shapes at batch 2
MAIN = [(16, 32, 4, 32), (16, 32, 32, 32), (16, 16, 64, 64),
        (16, 16, 128, 64), (16, 16, 128, 128), (16, 8, 192, 128),
        (16, 8, 128, 128), (16, 32, 64, 64), (16, 32, 32, 4)] + [
    (32, r, ci, co) for r, ci, co in STAGE1_K10_CASES + STAGE1_K10_DX]
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
