"""A PyTorch walk of K10's weight-gradient kernel (csrc/conv3d_wgrad.cu) on
the CPU, with the kernel's order of sums: per (channel tile, slab) block,
the slab's (item, brick) pairs in order, each brick's halo and g staged by
the kernel's voxel arithmetic (zeros outside the grid), each stream's runs
of 8 voxels along w with the 27 taps read as halo offsets, the streams
merged in order; then the sum kernel's order over the slabs (warp j sums
every 8th slab from j, then the warps in order). The walk equals
`torch.nn.grad.conv3d_weight` (the wrapper's plain version) within float32
round-off, at a small shape of each compiled tile, at the C4 -> 32 and
C3 -> 32 shapes of the U-Nets' first conv, on grids that end inside a
brick, and on slabs that end inside an item.
"""
import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.conv3d import (WGRAD_BRICK,
                                       _conv3d_weight_grad_plain, wgrad_plan)

from test_torch_port_sample import one_torch_thread  # noqa: F401

BD, BH, BW = WGRAD_BRICK
GROUPS = 8   # the sum kernel's warps


def _voxels(r, d0, h0, w0, halo):
    """The kernel's `voxel(i, halo)` for every halo cell (halo 1) or brick
    voxel (halo 0): the flat grid voxel, or -1 outside the grid."""
    wd, hd, dd = BW + 2 * halo, BH + 2 * halo, BD + 2 * halo
    i = torch.arange(dd * hd * wd)
    gw = w0 - halo + i % wd
    gh = h0 - halo + i // wd % hd
    gd = d0 - halo + i // (wd * hd)
    inside = ((gd >= 0) & (gd < r) & (gh >= 0) & (gh < r) & (gw >= 0)
              & (gw < r))
    return torch.where(inside, (gd * r + gh) * r + gw, -1)


def _walk(x, g, p):
    b, r, ci, co = x.shape[0], x.shape[1], x.shape[4], g.shape[4]
    nbh, nbw = -(-r // BH), -(-r // BW)
    bricks = -(-r // BD) * nbh * nbw
    hh, hw = BH + 2, BW + 2
    # a zero row last: index -1 reads it
    xz = torch.cat([x.float().reshape(b, r ** 3, ci),
                    torch.zeros(b, 1, ci)], 1)
    gz = torch.cat([g.float().reshape(b, r ** 3, co),
                    torch.zeros(b, 1, co)], 1)
    taps = torch.tensor([(kd * hh + kh) * hw + kw for kd in range(3)
                         for kh in range(3) for kw in range(3)])
    partials = []
    for s in range(p.slabs):
        acc = torch.zeros(p.streams, 27, ci, co)
        for q in range(s * p.per_slab, min((s + 1) * p.per_slab, p.pairs)):
            item, bx = divmod(q, bricks)
            d0 = bx // (nbh * nbw) * BD
            h0 = bx // nbw % nbh * BH
            w0 = bx % nbw * BW
            xs = xz[item, _voxels(r, d0, h0, w0, 1)]
            gs = gz[item, _voxels(r, d0, h0, w0, 0)]
            for run in range(BD * BH):
                base = (run // BH * hh + run % BH) * hw
                v = run % p.streams
                for w in range(BW):
                    acc[v] += (xs[base + w + taps][:, :, None]
                               * gs[run * BW + w][None, None, :])
        merged = acc[0]
        for v in range(1, p.streams):
            merged = merged + acc[v]
        partials.append(merged)
    sums = []
    for j in range(GROUPS):
        t = torch.zeros(27, ci, co)
        for k in range(j, p.slabs, GROUPS):
            t = t + partials[k]
        sums.append(t)
    dw = sums[0]
    for t in sums[1:]:
        dw = dw + t
    return dw.reshape(3, 3, 3, ci, co).to(x.dtype)


def _inputs(b, r, ci, co, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, r, r, r, ci).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, r, r, r, co).astype(np.float32))
    return x.to(dtype), g.to(dtype)


def _reference(x, g):
    """float64, and the sums of |x| |g| that bound float32 round-off."""
    def wgrad(a, c):
        return torch.nn.grad.conv3d_weight(
            a.double().permute(0, 4, 1, 2, 3),
            (c.shape[4], a.shape[4], 3, 3, 3),
            c.double().permute(0, 4, 1, 2, 3),
            padding=1).permute(2, 3, 4, 1, 0)
    return wgrad(x, g), wgrad(x.abs(), g.abs())


# (b, r, ci, co): each compiled tile (16 x 64, 32 x 32, 8 x 32 with four
# streams, 4 x 32 with eight), the U-Nets' first convs (C4 and C3 -> 32),
# grids that end inside a brick (r 5, 6, 12) and several channel tiles
CASES = [(2, 8, 16, 64), (1, 8, 32, 32), (2, 8, 8, 32), (2, 8, 4, 32),
         (2, 8, 3, 32), (1, 5, 4, 32), (1, 6, 20, 70), (1, 12, 48, 96),
         (3, 4, 7, 9)]


@pytest.mark.parametrize("b,r,ci,co", CASES)
def test_wgrad_walk_equals_conv3d_weight(b, r, ci, co):
    x, g = _inputs(b, r, ci, co, seed=b * 1000 + r * 10 + ci)
    p = wgrad_plan(b, r, ci, co, torch.float32)
    got = _walk(x, g, p)
    want, scale = _reference(x, g)
    # float32 sums of b r^3 products in two orders: a few ulps of the sum
    # of the terms' magnitudes
    tol = 4 * np.finfo(np.float32).eps * scale
    assert torch.all((got.double() - want).abs() <= tol + 1e-30)
    plain = _conv3d_weight_grad_plain(x, g)
    assert torch.all((plain.double() - want).abs() <= tol + 1e-30)


@pytest.mark.parametrize("per_slab", [1, 3, 5])
def test_wgrad_walk_holds_on_slabs_that_end_inside_an_item(per_slab):
    """Slabs of 3 and 5 bricks on items of 8 (the last slab shorter): any
    partition of the pairs gives the same dw within round-off."""
    x, g = _inputs(3, 8, 16, 64, seed=7)
    p = wgrad_plan(3, 8, 16, 64, torch.float32)
    p = p._replace(per_slab=per_slab, slabs=-(-p.pairs // per_slab))
    got = _walk(x, g, p)
    want, scale = _reference(x, g)
    assert torch.all((got.double() - want).abs()
                     <= 4 * np.finfo(np.float32).eps * scale + 1e-30)


def test_wgrad_walk_bf16_widens_and_rounds_once():
    """bf16 x and g: the products of their float32 widenings summed in
    float32, dw rounded once to bf16, as the plain version rounds it: the
    two differ by at most one bf16 ulp where the float32 sums straddle a
    rounding boundary."""
    x, g = _inputs(2, 8, 16, 64, seed=11, dtype=torch.bfloat16)
    p = wgrad_plan(2, 8, 16, 64, torch.bfloat16)
    got = _walk(x, g, p)
    plain = _conv3d_weight_grad_plain(x, g)
    assert got.dtype == plain.dtype == torch.bfloat16
    ulp = torch.finfo(torch.bfloat16).eps * plain.float().abs()
    assert torch.all((got.float() - plain.float()).abs() <= ulp + 1e-30)
