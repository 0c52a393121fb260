"""The trilinear devoxelization kernel (K5, csrc/devoxelize.cu) on the CPU:
its plan, its lane groups walked in PyTorch, and its affine epilogue.

The kernel runs only on the card (tests/test_torch_port_gpu.py); this file
holds what surrounds it:
  * `devox_plan` gives every point one lane group (a power of two, at most
    a warp) whose 16-byte chunks (one channel when C's row is not a
    multiple of 16 bytes) cover its row, and fills the H100's 132 SMs at
    every level the local step runs K5 (fp32 at batch 4 and 16, bf16 at
    batch 16), within the source's block;
  * a walk of the launch (thread g -> point g >> log2 L, lane g mod L,
    channels lane V + k L V) touches every output element once and, with
    each corner's chunk summed in the corners' order, equals the plain
    version bit for bit;
  * the epilogue: the plain version with (scale, bias) equals the plain
    version followed by `* scale + bias` bit for bit in fp32 (so PVConv's
    eval flow is unchanged there), and drops one bf16 rounding in bf16.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.voxel import (DEVOX_MAX_LANES, DEVOX_MAX_THREADS,
                                      DEVOX_MIN_BLOCKS, _corners,
                                      _trilinear_devoxelize_plain,
                                      devox_plan, normalize_coords,
                                      trilinear_devoxelize)
from lion_tpu_torch.profile_step import DEVOX_LEVELS

from test_torch_port_sample import one_torch_thread  # noqa: F401

SOURCE = (Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
          / "devoxelize.cu").read_text()
BF16 = torch.bfloat16


def _inputs(seed, b, n, r, c, dt):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(b, n, 3, generator=g) * 0.3
    nc = normalize_coords(xyz, r).contiguous()
    grid = torch.randn(b, r, r, r, c, generator=g).to(dt)
    scale = 1.0 + 0.3 * torch.randn(b, c, generator=g)
    bias = 0.2 * torch.randn(b, c, generator=g)
    return grid, nc, scale, bias


def test_plan_constants_are_the_sources():
    assert f"constexpr int kMaxThreads = {DEVOX_MAX_THREADS};" in SOURCE
    assert re.search(r"lanes_log2 > 5\b", SOURCE) and DEVOX_MAX_LANES == 32


@pytest.mark.parametrize("b,dt", [(4, torch.float32), (16, torch.float32),
                                  (16, BF16)])
def test_plan_covers_and_fills_every_level(b, dt):
    """At each (r, C, N) of the local step: one lane group a point covers
    its row in one step of 16-byte chunks, the block holds whole groups,
    and the launch has a block for each of the 132 SMs."""
    elem = torch.empty((), dtype=dt).element_size()
    for r, c, n in DEVOX_LEVELS:
        threads, lanes = devox_plan(b, n, c, elem)
        assert 32 <= threads <= DEVOX_MAX_THREADS and threads % 32 == 0
        assert lanes & (lanes - 1) == 0 and lanes <= DEVOX_MAX_LANES
        assert threads % lanes == 0
        vec = 16 // elem
        assert c * elem % 16 == 0 and lanes * vec == c, (r, c, n)
        assert -(-b * n * lanes // threads) >= DEVOX_MIN_BLOCKS, (r, c, n)


@pytest.mark.parametrize("c,elem", [(3, 4), (5, 4), (33, 4), (3, 2),
                                    (33, 2), (192, 4), (4, 2), (1, 4)])
def test_plan_of_other_widths(c, elem):
    """Rows off 16 bytes take one channel a lane and step; the group is the
    fewest lanes that reach C, at most a warp."""
    threads, lanes = devox_plan(2, 700, c, elem)
    vec = 16 // elem if c * elem % 16 == 0 else 1
    assert lanes == min(32, 1 << max(0, (-(-c // vec) - 1).bit_length()))
    assert threads % lanes == 0 and threads <= DEVOX_MAX_THREADS


def _walk(grid, nc, r, scale=None, bias=None):
    """The kernel's launch in PyTorch: every thread of every block of the
    plan takes its point, lane and channel chunks and sums the 8 corner
    chunks in order, then the epilogue and the one rounding."""
    b, c = grid.shape[0], grid.shape[-1]
    n = nc.shape[1]
    elem = grid.element_size()
    threads, lanes = devox_plan(b, n, c, elem)
    vec = 16 // elem if c * elem % 16 == 0 else 1
    blocks = -(-b * n * lanes // threads)
    flat = grid.reshape(b, r ** 3, c)
    corners = _corners(nc, r, grid.dtype)
    out = torch.full((b, n, c), float("nan"))
    hits = torch.zeros((b, n, c), dtype=torch.int32)
    g = torch.arange(blocks * threads)
    pt, lane = g // lanes, g % lanes
    keep = pt < b * n
    pt, lane = pt[keep], lane[keep]
    item, row = pt // n, pt % n
    for first in range(0, c, lanes * vec):
        for v in range(vec):
            ch = first + lane * vec + v
            ok = ch < c
            i, j, k = item[ok], row[ok], ch[ok]
            acc = torch.zeros(i.shape[0])
            for idx, w in corners:
                acc = acc + flat[i, idx[i, j], k].float() * w[i, j]
            if scale is not None:
                acc = acc * scale[i, k] + bias[i, k]
            out[i, j, k] = acc
            hits[i, j, k] += 1
    assert bool((hits == 1).all())
    return out.to(grid.dtype)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("r,c,n", [(8, 64, 300), (4, 3, 100), (4, 5, 64),
                                   (8, 33, 100), (8, 128, 64),
                                   (4, 192, 50)])
@pytest.mark.parametrize("affine", [False, True])
def test_walk_equals_the_plain_version(r, c, n, dt, affine):
    grid, nc, scale, bias = _inputs(r * c + n, 2, n, r, c, dt)
    args = (scale, bias) if affine else ()
    want = _trilinear_devoxelize_plain(grid, nc, r, *args)
    got = _walk(grid, nc, r, *args)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("r,c,n", [(32, 64, 2048), (16, 128, 1024),
                                   (8, 128, 256), (4, 5, 100)])
def test_fp32_epilogue_is_the_affine_after_devoxelize(r, c, n):
    """fp32: K5's epilogue equals its output followed by `* scale + bias`
    (PVConv's eval flow before the epilogue) bit for bit."""
    grid, nc, scale, bias = _inputs(n + c, 2, n, r, c, torch.float32)
    fused = trilinear_devoxelize(grid, nc, r, scale, bias)
    pts = trilinear_devoxelize(grid, nc, r)
    assert torch.equal(fused, pts * scale[:, None, :] + bias[:, None, :])


@pytest.mark.parametrize("r,c,n", [(32, 64, 2048), (8, 128, 256)])
def test_bf16_epilogue_drops_one_rounding(r, c, n):
    """bf16: the epilogue rounds the float32 sum's affine once; the old
    flow rounded the sum to bf16 first. They differ by at most one bf16
    rounding of the sum, carried through the scale, and the two outputs'
    roundings."""
    grid, nc, scale, bias = _inputs(n + c + 1, 2, n, r, c, BF16)
    fused = trilinear_devoxelize(grid, nc, r, scale, bias).float()
    pts = trilinear_devoxelize(grid, nc, r).float()
    old = (pts * scale[:, None, :] + bias[:, None, :]).to(BF16).float()
    s = _trilinear_devoxelize_plain(grid.float(), nc, r)   # fp32-ish sum
    limit = 2.0 ** -8 * ((s * scale[:, None, :]).abs() + fused.abs()
                         + old.abs()) + 1e-30
    assert bool(((fused - old).abs() <= limit).all())
    want = (sum(grid.reshape(2, r ** 3, c).float().gather(
        1, idx[:, :, None].expand(-1, -1, c)) * w[:, :, None]
        for idx, w in _corners(nc, r, BF16)) * scale[:, None, :]
        + bias[:, None, :]).to(BF16).float()
    assert torch.equal(fused, want)


def test_epilogue_form_has_no_gradient_and_the_plain_form_keeps_its_own():
    grid, nc, scale, bias = _inputs(3, 1, 50, 4, 8, torch.float32)
    grid.requires_grad_(True)
    scale.requires_grad_(True)
    assert not trilinear_devoxelize(grid, nc, 4, scale, bias).requires_grad
    out = trilinear_devoxelize(grid, nc, 4)
    out.sum().backward()
    assert grid.grad is not None and float(grid.grad.sum()) == \
        pytest.approx(50 * 8, rel=1e-5)


def test_devox_levels_are_the_local_steps():
    """DEVOX_LEVELS holds each (r, C_out, N) at which the local prior's
    PVConvs devoxelize (models/priors.py LOCAL_PRIOR_SA_BLOCKS and
    _FP_BLOCKS: SA0-SA2's convs at N 2048, 1024, 256, FP0-FP3's at 64, 256,
    1024, 2048)."""
    from lion_tpu_torch.models.priors import (LOCAL_PRIOR_FP_BLOCKS,
                                              LOCAL_PRIOR_SA_BLOCKS)
    sa_n, fp_n = (2048, 1024, 256), (64, 256, 1024, 2048)
    want = {(vres, c, n) for ((c, _, vres), _), n in
            zip(LOCAL_PRIOR_SA_BLOCKS[:3], sa_n)}
    want |= {(vres, c, n) for (_, (c, _, vres)), n in
             zip(LOCAL_PRIOR_FP_BLOCKS, fp_n)}
    assert set(DEVOX_LEVELS) == want
    assert np.all(np.diff([n for _, _, n in DEVOX_LEVELS]) <= 0)
