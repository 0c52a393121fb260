"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach (empty balls, fewer than three
centers, grids whose voxel count is not a multiple of the conv tile, odd
channel counts, clouds of unequal sizes for the EMD), in fp32 and in bf16.

Needs an NVIDIA GPU: every test is marked `gpu` and skips without CUDA.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_gpu.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from lion_tpu_torch import ops
from lion_tpu_torch.ops import voxel
from lion_tpu_torch.profile_step import (STAGE1_K10_CASES, STAGE1_K10_DX,
                                         WGRAD_STEPS)

pytestmark = pytest.mark.gpu
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _both(name, *args, **kwargs):
    w = ops.KERNELS[name]
    launches, plain_calls = w.launches, w.plain_calls
    got = w(*args, **kwargs)
    ref = w.plain(*args, **kwargs)
    torch.cuda.synchronize()
    # the wrapper launched its kernel and did not fall back
    assert (w.launches, w.plain_calls) == (launches + 1, plain_calls)
    return got, ref


@pytest.mark.parametrize("b,n,m,kind", [
    (3, 100, 37, "random"), (2, 2048, 1024, "random"), (1, 4000, 16, "random"),
    (2, 8, 8, "random"), (2, 2048, 1024, "grid"), (2, 300, 300, "grid"),
    (2, 20, 20, "grid"), (2, 16384, 64, "random"),
    # the local step's four levels at its batch
    (16, 2048, 1024, "level"), (16, 1024, 256, "level"),
    (16, 256, 64, "level"), (16, 64, 16, "level")])
def test_fps_kernel(gen, b, n, m, kind):
    if kind == "grid":      # integer coordinates: many exact ties
        xyz = torch.randint(-3, 4, (b, n, 3), generator=gen, device="cuda",
                            dtype=torch.int32).float()
    else:
        xyz = _randn(gen, b, n, 3, scale=0.3)
    if kind == "random":    # duplicated points: ties in the min-distance
        xyz[:, n // 2:n // 2 + 4] = xyz[:, :4]
    (idx, ctr), (ridx, rctr) = _both("fps", xyz, m)
    assert torch.equal(idx, ridx) and torch.equal(ctr, rctr)


@pytest.mark.parametrize("n,m,k,c,r", [(128, 24, 8, 5, 0.2), (300, 50, 32, 0, 0.5),
                                       (2048, 64, 32, 131, 0.4),
                                       (5000, 300, 32, 16, 0.1),
                                       (4100, 37, 13, 2, 0.3)])
def test_ball_query_group_kernel(gen, n, m, k, c, r):
    pts = _randn(gen, 2, n, 3, scale=0.3)
    ctr = pts[:, :m].clone()
    ctr[:, 0] = 5.0                                # an empty ball
    feats = _randn(gen, 2, n, c)
    got, ref = _both("ball_query_group", pts, ctr, feats, r, k)
    assert torch.equal(got, ref)


def _level_randn(gen):
    return lambda *shape, scale=1.0: _randn(gen, *shape, scale=scale)


@pytest.mark.parametrize("b", [4, 16])
def test_ball_query_group_kernel_at_the_sa_levels(gen, b):
    """K2 at the local step's four SA levels (profile_step's inputs): equal
    to its plain version, repeating bit for bit, and its balls K11's: the
    rows grouped from `ops.ball_query`'s indices are K2's rows."""
    from lion_tpu_torch.ops.points import grouping
    from lion_tpu_torch.profile_step import bqg_level_inputs
    for label, (p, c, f, r, k) in bqg_level_inputs(b, _level_randn(gen)):
        got, ref = _both("ball_query_group", p, c, f, r, k)
        assert torch.equal(got, ref), label
        again = ops.KERNELS["ball_query_group"](p, c, f, r, k)
        assert torch.equal(got, again), label
        idx = ops.ball_query(c, p, r, k)
        rows = torch.cat([grouping(p, idx) - c[:, :, None], grouping(f, idx)],
                         -1)
        assert torch.equal(got, rows), label


def _with_plan(entry, *args):
    from lion_tpu_torch.ops._cuda import launch
    launch(entry, *args)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cpb,threads", [(1, 32), (3, 64), (32, 256),
                                         (8, 128), (16, 32), (2, 256)])
def test_ball_query_group_kernel_on_other_plans(gen, cpb, threads):
    """Any plan the kernel takes (centers a block, threads; the cloud in
    one tile or in tiles of 256 points) gives the plain version's rows."""
    from lion_tpu_torch.ops._cuda import ptr, stream_of
    from lion_tpu_torch.ops.points import _r2
    pts = _randn(gen, 2, 900, 3, scale=0.3)
    ctr = pts[:, :77].clone()
    ctr[:, 0] = 5.0
    for c in (0, 5, 32):
        f = _randn(gen, 2, 900, c)
        ref = ops.KERNELS["ball_query_group"].plain(pts, ctr, f, 0.2, 32)
        for tile in (256, 900):
            out = torch.empty(2, 77, 32, 3 + c, device="cuda")
            _with_plan("lion_ball_query_group", ptr(pts), ptr(ctr), ptr(f),
                       ptr(out), 2, 900, 77, c, 32, _r2(0.2), 0, cpb,
                       threads, tile, stream_of(pts))
            assert torch.equal(out, ref)


def _ordered_mean(feats, vox, r):
    """The float32 sum of each cell's features in point order (np.add.at
    applies in index order), divided by the count, rounded once to the
    features' dtype; points outside the grid dropped, empty cells 0."""
    f = feats.float().cpu().numpy()
    v = vox.long().cpu().numpy()
    inside = np.all((v >= 0) & (v < r), axis=-1)
    cells = (v[..., 0] * r + v[..., 1]) * r + v[..., 2]
    out = np.zeros((f.shape[0], r ** 3, f.shape[-1]), np.float32)
    for i in range(f.shape[0]):
        keep = inside[i]
        sums = np.zeros((r ** 3, f.shape[-1]), np.float32)
        np.add.at(sums, cells[i][keep], f[i][keep])
        count = np.bincount(cells[i][keep], minlength=r ** 3)
        out[i] = np.where(count[:, None] > 0,
                          sums / np.maximum(count, 1)[:, None]
                          .astype(np.float32), np.float32(0))
    return torch.from_numpy(out).reshape(
        f.shape[0], r, r, r, f.shape[-1]).to(feats.dtype)


@pytest.mark.parametrize("r,c", [(5, 3), (8, 192), (32, 64)])
def test_voxelize_kernels(gen, r, c):
    xyz = _randn(gen, 2, 700, 3, scale=0.3)
    nc = voxel.normalize_coords(xyz, r).contiguous()
    vox = torch.round(nc).to(torch.int32)
    feats = _randn(gen, 2, 700, c)
    got, ref = _both("avg_voxelize", feats, vox, r)
    # the plain version on the card scatters with atomics in varying order
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.cpu(), _ordered_mean(feats, vox, r))
    grid = _randn(gen, 2, r, r, r, c)
    got, ref = _both("trilinear_devoxelize", grid, nc, r)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("r,c", [(5, 3), (8, 64), (16, 192), (32, 64),
                                 (32, 3), (8, 192)])
@pytest.mark.parametrize("edge", [None, "one cell", "outside", "odd n"])
def test_voxelize_kernel_is_the_ordered_mean(gen, dt, r, c, edge):
    """K3 bit-equal to the ordered float32 reference: empty cells (most of
    the grid at r 32), all points in one cell, points outside the grid
    (dropped), N not a multiple of the ordering warp's 32 or the block."""
    n = 1037 if edge == "odd n" else 2048
    xyz = _randn(gen, 3, n, 3, scale=0.3)
    vox = torch.round(voxel.normalize_coords(xyz, r)).to(torch.int32)
    if edge == "one cell":
        vox[:] = vox[:, :1]
    elif edge == "outside":
        vox[:, ::5, 0] = r
        vox[:, 1::7, 2] = -1
    feats = _randn(gen, 3, n, c).to(dt)
    w = ops.KERNELS["avg_voxelize"]
    launches = w.launches
    got = ops.avg_voxelize(feats, vox.contiguous(), r)
    assert w.launches == launches + 1 and got.dtype == dt
    assert torch.equal(got.cpu(), _ordered_mean(feats, vox, r))


def test_voxelize_kernel_beyond_shared_memory(gen):
    """r = 40: the ordering launch keeps its counts in the global scratch."""
    r = 40
    vox = torch.round(voxel.normalize_coords(
        _randn(gen, 2, 3000, 3, scale=0.3), r)).to(torch.int32)
    feats = _randn(gen, 2, 3000, 16)
    assert voxel.vox_order_smem(3000, r) == 0
    got = ops.avg_voxelize(feats, vox, r)
    assert torch.equal(got.cpu(), _ordered_mean(feats, vox, r))


# K4's cases: (r, ci, co, affine, swish). affine 3.0 shifts the prologue's
# input by ~3, so that pro(0) = swish(3) != 0 and a kernel that ran the
# prologue over the zero halo would fail. The main-path shapes, partial
# bricks (r = 2, 3, 5, 7), Co off a multiple of 16 and Ci below a fragment
CONV_CASES = [
    (5, 4, 32, False, False), (8, 192, 128, True, True),
    (16, 128, 64, False, False), (4, 7, 9, True, False),
    (3, 16, 70, False, True),
    (32, 64, 64, True, True), (32, 4, 32, False, False),
    (32, 32, 32, True, True), (16, 64, 64, True, True),
    (16, 128, 128, False, False), (8, 128, 128, True, True),
    (2, 3, 4, True, True), (7, 12, 24, True, True), (5, 12, 24, False, False),
    (3, 7, 70, True, False), (7, 32, 9, 3.0, True), (5, 64, 24, 3.0, True),
    (8, 4, 32, 3.0, True), (16, 12, 70, 3.0, True)]


def _conv_inputs(gen, r, ci, co, affine, dtype=torch.float32):
    x = _randn(gen, 2, r, r, r, ci).to(dtype)
    w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
    s = 1.0 + _randn(gen, 2, ci, scale=0.1) if affine else None
    shift = 0.0 if affine is True else float(affine)
    bb = shift + _randn(gen, 2, ci, scale=0.1) if affine else None
    return x, w, s, bb


@pytest.mark.parametrize("r,ci,co,affine,swish", CONV_CASES)
def test_conv3d_kernel(gen, r, ci, co, affine, swish):
    x, w, s, bb = _conv_inputs(gen, r, ci, co, affine)
    (y, st), (yr, sr) = _both("conv3d_3x3_fused", x, w, s, bb,
                              pre_swish=swish)
    # fp32 sums of 27*Ci terms in another order (cuDNN, TF32 off)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st, sr, rtol=1e-4,
                               atol=1e-4 * float(sr.abs().max()))


@pytest.mark.parametrize("n,m,c", [(200, 64, 7), (50, 2, 4), (30, 1, 3),
                                   (2048, 1500, 192)])
def test_three_nn_kernel(gen, n, m, c):
    p = _randn(gen, 2, n, 3, scale=0.3)
    ctr = _randn(gen, 2, m, 3, scale=0.3)
    got, ref = _both("three_nn_interpolate", p, ctr, _randn(gen, 2, m, c))
    assert torch.equal(got, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    xyz = _randn(gen, 1, 64, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fps(xyz.transpose(1, 2).contiguous().transpose(1, 2), 8)
    with pytest.raises(TypeError):
        ops.fps(xyz.double(), 8)
    with pytest.raises(ValueError, match="aligned"):
        ops.fps(_randn(gen, 1, 65, 3).reshape(-1)[3:].reshape(1, 64, 3), 8)


# ------------------------------------------------------------------ bf16
def _assert_bf16_close(got, ref, rel):
    """bf16 outputs whose float32 sums were taken in another order: a
    rounding may land one bf16 ulp (2^-8 relative) apart, and a flip in an
    early stage moves what follows by about as much."""
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=rel,
                               atol=rel * scale)


@pytest.mark.parametrize("r,c", [(5, 3), (8, 128), (32, 64)])
def test_voxelize_kernels_bf16(gen, r, c):
    xyz = _randn(gen, 2, 700, 3, scale=0.3)
    nc = voxel.normalize_coords(xyz, r).contiguous()
    vox = torch.round(nc).to(torch.int32)
    feats = _randn(gen, 2, 700, c).to(BF16)
    got, ref = _both("avg_voxelize", feats, vox, r)
    assert got.dtype == BF16
    # the plain version's fp32 atomic sums in varying order, then one bf16
    # rounding
    torch.testing.assert_close(got.float(), ref.float(), rtol=8e-3,
                               atol=1e-6)
    assert torch.equal(got.cpu(), _ordered_mean(feats, vox, r))
    grid = _randn(gen, 2, r, r, r, c).to(BF16)
    got, ref = _both("trilinear_devoxelize", grid, nc, r)
    assert got.dtype == BF16 and torch.equal(got, ref)


@pytest.mark.parametrize("n,m,c", [(200, 64, 7), (50, 2, 4),
                                   (2048, 1024, 192), (300, 100, 12),
                                   (77, 33, 100), (64, 3, 1)])
def test_three_nn_kernel_bf16(gen, n, m, c):
    p = _randn(gen, 2, n, 3, scale=0.3)
    ctr = _randn(gen, 2, m, 3, scale=0.3)
    f = _randn(gen, 2, m, c).to(BF16)
    got, ref = _both("three_nn_interpolate", p, ctr, f)
    assert got.dtype == BF16 and torch.equal(got, ref)


@pytest.mark.parametrize("r,ci,co,affine,swish", [
    (32, 4, 32, False, False), (32, 32, 32, True, True),
    (16, 128, 64, False, False), (8, 192, 128, True, True),
    (5, 12, 24, True, False), (3, 16, 70, False, True)] + CONV_CASES[5:])
def test_conv3d_kernel_bf16(gen, r, ci, co, affine, swish):
    x, w, s, bb = _conv_inputs(gen, r, ci, co, affine, BF16)
    (y, st), (yr, sr) = _both("conv3d_3x3_fused", x, w, s, bb,
                              pre_swish=swish)
    assert y.dtype == BF16
    _assert_bf16_close(y, yr, 1e-2)
    # sums of up to 32768 rounded outputs: a few one-ulp flips
    torch.testing.assert_close(st, sr, rtol=1e-2,
                               atol=1e-3 * float(sr.abs().max()))


# the main path's r32 C64, other widths, and grids that are no whole number
# of bricks (r = 4, 5, 3 against the 8 x 8 planes)
@pytest.mark.parametrize("r,c", [(32, 64), (16, 32), (8, 128), (4, 8),
                                 (5, 64), (3, 24)])
def test_conv_pair_kernel(gen, r, c):
    x = _randn(gen, 2, r, r, r, c).to(BF16)
    w0 = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    w1 = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    b0 = _randn(gen, c, scale=0.1)
    ca = 1.0 + _randn(gen, 2, c, scale=0.1)
    cb = _randn(gen, 2, c, scale=0.1)
    (y, st), (yr, sr) = _both("conv3d_pair", x, w0, b0, ca, cb, w1)
    assert y.dtype == BF16
    _assert_bf16_close(y, yr, 2e-2)
    torch.testing.assert_close(st, sr, rtol=2e-2,
                               atol=2e-3 * float(sr.abs().max()))


@pytest.mark.parametrize("n", [64, 256, 2048, 4096])
def test_pvconv_block_kernel(gen, n):
    b, r, c = 3, 8, 128
    xyz = _randn(gen, b, n, 3, scale=0.3)
    nc = voxel.normalize_coords(xyz, r).contiguous()
    vox = torch.round(nc).to(torch.int32)
    feats = _randn(gen, b, n, c).to(BF16)
    w0 = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    w1 = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    b0 = _randn(gen, c, scale=0.1)
    ca = 1.0 + _randn(gen, b, c, scale=0.1)
    cb = _randn(gen, b, c, scale=0.1)
    (pts, st), (pr, sr) = _both("pvconv_block_pair", feats, vox, nc, w0, b0,
                                ca, cb, w1, r)
    assert pts.dtype == BF16 and pts.shape == (b, n, c)
    _assert_bf16_close(pts, pr, 2e-2)
    torch.testing.assert_close(st, sr, rtol=2e-2,
                               atol=2e-3 * float(sr.abs().max()))


def _repeat(label, fn):
    """Run fn twice; print whether the two results are bit-equal and
    return both."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    diff = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))
    print(f"[repeat] {label}: bit-equal {same}, max |run 1 - run 2| "
          f"{diff:.3e}", flush=True)
    return a, b


def test_repeat_runs_on_the_same_inputs(gen):
    """Run-to-run reproducibility: each of these, run twice on the same
    inputs, must repeat bit for bit. K3 (fp32 and bf16 at B16 r32 C64), K7
    (SA0 and SA3 at B16), K4 (fp32 and bf16 at the local step's widest
    shapes), K8 at r32 C64, K9 at r8 C128 N256, the full-width local-prior
    forward in bf16 at batch 16 and in fp32 at batch 4, and a 10-step
    `LION.sample` under `given_noise` on each path. No kernel adds floats
    with atomics: K3 and K9's voxelize sum each cell in point order, K4's
    and K8's statistics are summed from per-warp slots and per-block
    partials in a fixed order, K7 merges its statistics in a fixed tree and
    K9 sums its statistics in rank order."""
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.models.registry import build_local_prior
    from lion_tpu_torch.nn import init_weights
    b = 16
    vox = torch.round(voxel.normalize_coords(
        _randn(gen, b, 2048, 3, scale=0.3), 32)).to(torch.int32)
    f64 = _randn(gen, b, 2048, 64)
    for dt in (torch.float32, BF16):
        x = f64.to(dt)
        a, r = _repeat(f"avg_voxelize {dt} B16 r32 C64",
                       lambda: ops.avg_voxelize(x, vox, 32))
        assert torch.equal(a[0], r[0])
    for label, shape in (("SA0", (2048, 1024, 32, (32, 64), 0.1)),
                         ("SA3", (64, 16, 32, (128, 128, 128), 0.8))):
        args = _sa_inputs(gen, b, *shape)
        a, r = _repeat(f"sa_fused B16 {label}", lambda: ops.sa_fused(*args))
        assert torch.equal(a[0], r[0])
    for r, ci, co, dt in ((32, 64, 64, torch.float32),
                          (16, 128, 64, torch.float32),
                          (32, 32, 32, BF16), (16, 128, 128, BF16),
                          (8, 128, 128, BF16)):
        x = _randn(gen, b, r, r, r, ci).to(dt)
        w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dt)
        sc, sh = 1.0 + _randn(gen, b, ci, scale=0.1), _randn(gen, b, ci,
                                                             scale=0.1)
        for a, r2 in zip(*_repeat(
                f"conv3d_3x3_fused {dt} B16 r{r} C{ci}->{co}",
                lambda: ops.conv3d_3x3_fused(x, w, sc, sh, pre_swish=True))):
            assert torch.equal(a, r2)
    c = 64
    x = _randn(gen, b, 32, 32, 32, c).to(BF16)
    w = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    pair = (x, w, _randn(gen, c, scale=0.1),
            1.0 + _randn(gen, b, c, scale=0.1), _randn(gen, b, c, scale=0.1),
            w)
    for a, r in zip(*_repeat("conv3d_pair B16 r32 C64",
                             lambda: ops.conv3d_pair(*pair))):
        assert torch.equal(a, r)
    xyz = _randn(gen, b, 256, 3, scale=0.3)
    nc = voxel.normalize_coords(xyz, 8).contiguous()
    c = 128
    w = _randn(gen, 3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(BF16)
    block = (_randn(gen, b, 256, c).to(BF16),
             torch.round(nc).to(torch.int32), nc, w,
             _randn(gen, c, scale=0.1), 1.0 + _randn(gen, b, c, scale=0.1),
             _randn(gen, b, c, scale=0.1), w, 8)
    for a, r in zip(*_repeat("pvconv_block_pair B16 r8 C128 N256",
                             lambda: ops.pvconv_block_pair(*block))):
        assert torch.equal(a, r)
    g = torch.Generator().manual_seed(8)
    for bf16, batch in ((True, 16), (False, 4)):
        cfg = flagship_cfg()
        cfg.tpu.bf16 = bf16
        net = build_local_prior(cfg).eval()
        init_weights(net, torch.Generator().manual_seed(7))
        net = net.cuda()
        xs = (torch.randn(batch, 2048, 4, generator=g)
              * torch.tensor([0.3, 0.3, 0.3, 1.0])).reshape(batch, -1).cuda()
        t = torch.full((batch,), 500.0, device="cuda")
        cond = torch.randn(batch, 128, generator=g).cuda()
        with torch.no_grad():
            (a,), (r,) = _repeat(
                f"local prior forward {'bf16' if bf16 else 'fp32'} B{batch}",
                lambda: net(xs, t, condition_input=cond))
        assert torch.isfinite(a).all() and torch.equal(a, r)
    for bf16, batch in ((False, 4), (True, 16)):
        cfg = flagship_cfg()
        cfg.tpu.bf16 = bf16
        cfg.ddpm.num_steps = 10
        lion = LION(cfg).init_params(torch.Generator().manual_seed(3))
        rs = np.random.RandomState(12)
        noise = tuple(
            (torch.from_numpy(rs.randn(batch, d).astype(np.float32)).cuda(),
             torch.from_numpy(rs.randn(10, batch, d).astype(np.float32))
             .cuda())
            for d in (lion.style_dim, lion.local_dim))

        def sample():
            out = lion.sample(batch, given_noise=noise)
            return out["z_global"], out["z_local"], out["points"]
        a, r = _repeat(f"LION.sample 10 steps given_noise "
                       f"{'bf16' if bf16 else 'fp32'} B{batch}", sample)
        assert all(torch.isfinite(x).all() for x in a)
        assert all(torch.equal(x, y) for x, y in zip(a, r))


def _sa_inputs(gen, b, n, m, k, widths, radius_ball):
    pts = _randn(gen, b, n, 3, scale=0.3)
    ctr = pts[:, :m].clone()
    ctr[:, 0] = 5.0                              # an empty ball
    c0 = 6
    feats = _randn(gen, b, n, c0)
    w1 = _randn(gen, 3 + c0, widths[0], scale=0.3)
    a = (torch.cat([pts, feats], -1) @ w1).contiguous()
    bc = -(ctr @ w1[:3]).contiguous()
    ws = [_randn(gen, ci, co, scale=ci ** -0.5).to(BF16)
          for ci, co in zip(widths[:-1], widths[1:])]
    bs = [_randn(gen, co, scale=0.1) for co in widths[1:]]
    cas = [1.0 + _randn(gen, b, co, scale=0.2) for co in widths]
    cbs = [_randn(gen, b, co, scale=0.2) for co in widths]
    return pts, ctr, a, bc, ws, bs, cas, cbs, radius_ball, k


@pytest.mark.parametrize("n,m,k,widths,radius", [
    (2048, 1024, 32, (32, 64), 0.1),          # SA0
    (64, 16, 32, (128, 128, 128), 0.8),       # SA3
    (300, 64, 8, (24,), 0.05),                # partial balls, one layer
    (500, 40, 8, (16, 40, 8), 0.2),           # K = 8, three layers
    (256, 128, 16, (64, 128), 0.3),
    (512, 64, 128, (32, 64), 0.4),            # K = 128
    (256, 32, 32, (256, 64), 0.3),            # a width of 256
    (20000, 8, 8, (8,), 0.05)])               # a cloud read through L2
def test_sa_fused_kernel(gen, n, m, k, widths, radius):
    args = _sa_inputs(gen, 2, n, m, k, widths, radius)
    got, ref = _both("sa_fused", *args)
    assert got.dtype == BF16 and got.shape == (2, m, widths[-1])
    # GroupNorm over bf16 rows: statistics summed in another order (and
    # merged in float64 on the card) move a few roundings by one ulp
    assert torch.equal(got, ops.sa_fused(*args))   # bit-reproducible
    _assert_bf16_close(got, ref, 2e-2)


def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(gen):
    c = 128
    feats = _randn(gen, 1, 64, c).to(BF16)
    nc = voxel.normalize_coords(_randn(gen, 1, 64, 3), 8).contiguous()
    vox = torch.round(nc).to(torch.int32)
    w = _randn(gen, 3, 3, 3, c, c).to(BF16)
    b0, ca, cb = _randn(gen, c), _randn(gen, 1, c), _randn(gen, 1, c)
    for bad in ((feats, vox, nc, w, b0, ca, cb, w, 16),      # r != 8
                (feats[:, :60].contiguous(), vox[:, :60].contiguous(),
                 nc[:, :60].contiguous(), w, b0, ca, cb, w, 8)):  # N % 8
        with pytest.raises(ValueError, match="pvconv_block_pair"):
            ops.pvconv_block_pair(*bad)
    with pytest.raises(TypeError):
        ops.pvconv_block_pair(feats.float(), vox, nc, w, b0, ca, cb, w, 8)
    x = _randn(gen, 1, 8, 8, 8, c).to(BF16)
    with pytest.raises(ValueError, match="conv3d_pair"):
        ops.conv3d_pair(x, w[..., :64].contiguous(), b0, ca, cb, w)
    with pytest.raises(TypeError):
        ops.conv3d_pair(x.float(), w, b0, ca, cb, w)
    with pytest.raises(TypeError):
        ops.conv3d_3x3_fused(x, w.float())
    with pytest.raises(TypeError):
        ops.avg_voxelize(feats.half(), vox, 8)
    args = list(_sa_inputs(gen, 1, 64, 16, 32, (32, 64), 0.3))
    for k, widths in ((12, (32, 64)), (32, (32, 60)), (256, (32, 64))):
        bad = list(_sa_inputs(gen, 1, 64, 16, k, widths, 0.3))
        with pytest.raises(ValueError, match="sa_fused"):
            ops.sa_fused(*bad)
    args[4] = [w.float() for w in args[4]]
    with pytest.raises(TypeError):
        ops.sa_fused(*args)


# ------------------------------------------------------- training slice
def _flip(w):
    """The dx form's weights: taps flipped, Ci and Co swapped."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


@pytest.mark.parametrize("r", [2, 3, 4, 5, 7, 8, 16, 32])
@pytest.mark.parametrize("ci,co", [(3, 4), (4, 96), (96, 192), (192, 3),
                                   (4, 32), (64, 64), (128, 64), (192, 128),
                                   (7, 9), (12, 24), (32, 70)])
def test_conv3d_same_kernel(gen, r, ci, co):
    """K10 forward, and the dx form: the output gradient through the
    flipped, channel-transposed weights."""
    x = _randn(gen, 2, r, r, r, ci)
    w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    g = _randn(gen, 2, r, r, r, co)
    # fp32 sums of 27*Ci (27*Co) terms in another order (cuDNN, TF32 off)
    for inp, wt in ((x, w), (g, _flip(w))):
        got, ref = _both("conv3d_3x3_same", inp, wt)
        assert got.shape == inp.shape[:4] + (wt.shape[-1],)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,k,r", [(128, 24, 8, 0.2), (300, 37, 64, 0.5),
                                     (2048, 1000, 32, 0.1), (50, 5, 64, 2.0),
                                     (1024, 256, 32, 0.2), (5000, 300, 13, 0.1),
                                     (4100, 37, 32, 0.3)])
def test_ball_query_kernel(gen, n, m, k, r):
    """Empty balls, partial balls, K above the cloud's size, M off the
    plan's block of centers, K % 4 != 0, N beyond one cloud tile."""
    pts = _randn(gen, 2, n, 3, scale=0.3)
    ctr = pts[:, :m].clone()
    ctr[:, 0] = 5.0                                # an empty ball
    got, ref = _both("ball_query", ctr, pts, r, k)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("b", [4, 16])
def test_ball_query_kernel_at_the_sa_levels(gen, b):
    """K11 at the local step's four SA levels (profile_step's inputs):
    equal to its plain version and repeating bit for bit."""
    from lion_tpu_torch.profile_step import bqg_level_inputs
    for label, (p, c, _, r, k) in bqg_level_inputs(b, _level_randn(gen)):
        got, ref = _both("ball_query", c, p, r, k)
        assert torch.equal(got, ref), label
        assert torch.equal(got, ops.ball_query(c, p, r, k)), label


@pytest.mark.parametrize("cpb,threads", [(1, 32), (3, 64), (32, 256),
                                         (8, 128), (16, 32), (2, 256)])
def test_ball_query_kernel_on_other_plans(gen, cpb, threads):
    """Any plan the kernel takes (centers a block, threads; the cloud in
    one tile or in tiles of 256 points) gives the plain version's balls,
    in 16-byte chunks (K = 32) or single ints (K = 13)."""
    from lion_tpu_torch.ops._cuda import ptr, stream_of
    from lion_tpu_torch.ops.points import _r2
    pts = _randn(gen, 2, 900, 3, scale=0.3)
    ctr = pts[:, :77].clone()
    ctr[:, 0] = 5.0
    for k in (32, 13):
        ref = ops.KERNELS["ball_query"].plain(ctr, pts, 0.2, k)
        for tile in (256, 900):
            out = torch.empty(2, 77, k, dtype=torch.int32, device="cuda")
            _with_plan("lion_ball_query", ptr(ctr), ptr(pts), ptr(out), 2,
                       900, 77, k, _r2(0.2), cpb, threads, tile,
                       stream_of(pts))
            assert torch.equal(out, ref)


@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_three_nn_kernel_at_the_fp_levels(gen, b, dt):
    """K6 at the local step's four FP levels (profile_step's inputs), with
    and without (idx, w): equal to its plain version, repeating bit for
    bit."""
    from lion_tpu_torch.profile_step import three_nn_level_inputs
    for label, (p, c, f) in three_nn_level_inputs(b, _level_randn(gen)):
        f = f.to(dt)
        got, ref = _both("three_nn_interpolate", p, c, f)
        assert got.dtype == dt and torch.equal(got, ref), label
        again = ops.KERNELS["three_nn_interpolate"](p, c, f)
        assert torch.equal(again, got), label
        gw, rw = _both("three_nn_interpolate", p, c, f, with_weights=True)
        assert torch.equal(gw[0], got), label
        for a, r in zip(gw, rw):
            assert a.dtype == r.dtype and torch.equal(a, r), label


@pytest.mark.parametrize("threads,lanes", [(32, 1), (32, 32), (64, 8),
                                           (128, 2), (256, 16), (256, 4)])
@pytest.mark.parametrize("m", [700, 1100])
def test_three_nn_kernel_on_other_plans(gen, threads, lanes, m):
    """Any plan the kernel takes (threads, lanes a point), with the centers
    in one tile or two, gives the plain version's output, indices and
    weights, on the chunked and the generic output paths, fp32 and bf16."""
    from lion_tpu_torch.ops._cuda import ptr, stream_of
    p = _randn(gen, 2, 333, 3, scale=0.3)
    ctr = _randn(gen, 2, m, 3, scale=0.3)
    for c, dt in ((192, torch.float32), (7, torch.float32), (192, BF16),
                  (12, BF16)):
        f = _randn(gen, 2, m, c).to(dt)
        out = torch.empty(2, 333, c, device="cuda", dtype=dt)
        idx = torch.empty(2, 333, 3, device="cuda", dtype=torch.int32)
        w = torch.empty(2, 333, 3, device="cuda")
        _with_plan("lion_three_nn_interpolate", ptr(p), ptr(ctr), ptr(f),
                   ptr(out), ptr(idx), ptr(w), 2, 333, m, c,
                   int(dt == BF16), threads, lanes, stream_of(p))
        ref = ops.KERNELS["three_nn_interpolate"].plain(p, ctr, f,
                                                        with_weights=True)
        for a, r in zip((out, idx, w), ref):
            assert torch.equal(a, r)


def test_three_nn_kernel_weights_output(gen):
    p = _randn(gen, 2, 2048, 3, scale=0.3)
    ctr = _randn(gen, 2, 1024, 3, scale=0.3)
    f = _randn(gen, 2, 1024, 64)
    got, ref = _both("three_nn_interpolate", p, ctr, f, with_weights=True)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _grads_on_card_and_cpu(fn, *inputs, grad_out):
    """fn's outputs and the gradients of its float inputs that require
    one, on the card and on the CPU (plain versions), with one cotangent."""
    runs = []
    for dev in ("cuda", "cpu"):
        xs = [t.detach().to(dev).requires_grad_(t.requires_grad)
              if t.is_floating_point() else t.to(dev) for t in inputs]
        out = fn(*xs)
        out.backward(grad_out.to(dev))
        runs.append((out.detach().cpu(),
                     [t.grad.cpu() for t in xs if t.grad is not None]))
    return runs


def test_training_ops_backward_on_card_matches_cpu(gen):
    """Every autograd.Function of the training path, forward and backward,
    on the card against the CPU."""
    ops.reset_counts()
    # K10: dx by K10, dw by cuDNN's weight gradient
    x = _randn(gen, 2, 8, 8, 8, 4).requires_grad_(True)
    w = _randn(gen, 3, 3, 3, 4, 32, scale=(27 * 4) ** -0.5).requires_grad_(
        True)
    (y, gs), (yr, gr) = _grads_on_card_and_cpu(
        ops.conv3d_3x3_same, x, w, grad_out=_randn(gen, 2, 8, 8, 8, 32))
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    for a, b in zip(gs, gr):   # sums over 2 * 8^3 voxels for dw
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # K2 forward, K11 in the backward; gradients to all three inputs
    pts = _randn(gen, 2, 512, 3, scale=0.3).requires_grad_(True)
    ctr = (pts[:, :64].detach() + 0.01).requires_grad_(True)
    feats = _randn(gen, 2, 512, 16).requires_grad_(True)
    (o, gs), (orf, gr) = _grads_on_card_and_cpu(
        lambda p, c, f: ops.ball_query_group(p, c, f, 0.2, 32), pts, ctr,
        feats, grad_out=_randn(gen, 2, 64, 32, 19))
    assert torch.equal(o, orf) and len(gs) == 3
    for a, b in zip(gs, gr):   # the centers' sums over K in another order
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # K3 and K5 with their transposes
    nc = voxel.normalize_coords(pts.detach(), 16).contiguous()
    vox = torch.round(nc).to(torch.int32)
    (o, gs), (orf, gr) = _grads_on_card_and_cpu(
        lambda f: ops.avg_voxelize(f, vox.to(f.device), 16), feats,
        grad_out=_randn(gen, 2, 16, 16, 16, 16))
    torch.testing.assert_close(o, orf, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gs[0], gr[0], rtol=1e-6, atol=1e-6)
    grid = _randn(gen, 2, 16, 16, 16, 8).requires_grad_(True)
    (o, gs), (orf, gr) = _grads_on_card_and_cpu(
        lambda gg: ops.trilinear_devoxelize(gg, nc.to(gg.device), 16), grid,
        grad_out=_randn(gen, 2, 512, 8))
    assert torch.equal(o, orf)
    torch.testing.assert_close(gs[0], gr[0], rtol=1e-5, atol=1e-5)
    # K6 with its (idx, w) output; the backward needs no distance matrix
    cf = _randn(gen, 2, 64, 24).requires_grad_(True)
    (o, gs), (orf, gr) = _grads_on_card_and_cpu(
        lambda f: ops.nearest_neighbor_interpolate(
            pts.detach().to(f.device), ctr.detach().to(f.device), f), cf,
        grad_out=_randn(gen, 2, 512, 24))
    assert torch.equal(o, orf)
    torch.testing.assert_close(gs[0], gr[0], rtol=1e-5, atol=1e-5)
    for name in ("conv3d_3x3_same", "ball_query_group", "ball_query",
                 "avg_voxelize", "trilinear_devoxelize",
                 "three_nn_interpolate"):
        w_ = ops.KERNELS[name]
        # the card's runs launched the kernels; the plain calls are the
        # CPU runs', one per launch
        assert w_.launches > 0 and w_.launches == w_.plain_calls, name


# ----------------------------------------------------------- K5 redesign
@pytest.mark.parametrize("b", [4, 16])
@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_devoxelize_kernel_at_the_levels(gen, b, dt):
    """K5 at the local step's levels (profile_step's inputs), with and
    without the affine epilogue: equal to its plain version bit for bit,
    repeating bit for bit; in fp32 the epilogue equals K5 followed by the
    affine, as PVConv computed it before the epilogue."""
    from lion_tpu_torch.profile_step import devox_level_inputs
    for label, args, (sc, bi) in devox_level_inputs(b, _level_randn(gen),
                                                     dt):
        got, ref = _both("trilinear_devoxelize", *args)
        assert got.dtype == dt and torch.equal(got, ref), label
        fused, fref = _both("trilinear_devoxelize", *args, sc, bi)
        assert fused.dtype == dt and torch.equal(fused, fref), label
        for out, extra in ((got, ()), (fused, (sc, bi))):
            again = ops.KERNELS["trilinear_devoxelize"](*args, *extra)
            assert torch.equal(again, out), label
        if dt == torch.float32:
            assert torch.equal(fused, got * sc[:, None] + bi[:, None]), label


@pytest.mark.parametrize("c", [3, 5, 33, 8, 192])
@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_devoxelize_kernel_other_widths(gen, c, dt):
    """Rows off 16 bytes (one channel a lane), rows wider than a warp's
    chunks, and coordinates on the grid's cells and faces (frac == 0, the
    hi corner collapsing onto lo), with and without the epilogue."""
    r, n = 8, 777
    nc = voxel.normalize_coords(_randn(gen, 3, n, 3, scale=0.3),
                                r).contiguous()
    nc[:, :50] = torch.floor(nc[:, :50])
    nc[:, 50:60, 0] = float(r - 1)
    grid = _randn(gen, 3, r, r, r, c).to(dt)
    sc, bi = 1.0 + _randn(gen, 3, c, scale=0.2), _randn(gen, 3, c, scale=0.2)
    for extra in ((), (sc, bi)):
        got, ref = _both("trilinear_devoxelize", grid, nc, r, *extra)
        assert got.dtype == dt and torch.equal(got, ref)


def test_devoxelize_kernel_refuses_a_half_affine(gen):
    grid = _randn(gen, 2, 4, 4, 4, 8)
    nc = torch.full((2, 10, 3), 1.5, device="cuda")
    sc = _randn(gen, 2, 8)
    with pytest.raises(ValueError, match="scale and bias"):
        ops.KERNELS["trilinear_devoxelize"](grid, nc, 4, sc, None)
    with pytest.raises(ValueError, match="scale and bias"):
        ops.KERNELS["trilinear_devoxelize"](grid, nc, 4, sc[:1], sc[:1])


# ------------------------------------------------------- evaluation slice
# K12 against its plain version: the JAX package's gate between its EMD
# kernel and its XLA form (tests/test_ops.py:291); exp(level * d2) at |level|
# up to 16384 amplifies the rounding of sums taken in another order
EMD_RTOL, EMD_ATOL = 2e-3, 1e-5


@pytest.mark.parametrize("s,n,r,m", [(3, 2000, 2, 77), (2, 77, 3, 2000),
                                     (2, 256, 2, 512), (2, 512, 3, 256),
                                     (2, 2048, 2, 2048), (1, 1, 1, 5)])
def test_emd_cost_kernel(gen, s, n, r, m):
    """N and M off any block multiple, N != M both ways (integer capacity
    ratios), and the pair list in any order with repeats."""
    a = _randn(gen, s, n, 3, scale=0.3)
    b = _randn(gen, r, m, 3, scale=0.3)
    pairs = torch.tensor([[i, j] for i in range(s) for j in range(r)]
                         + [[s - 1, 0], [0, r - 1]], dtype=torch.int32,
                         device="cuda")
    got, ref = _both("emd_cost", a, b, pairs)
    assert got.shape == (pairs.shape[0],) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=EMD_RTOL, atol=EMD_ATOL)
    # a repeated pair gives the same cost bit for bit (fixed-order sums)
    assert got[-2] == got[(s - 1) * r] and got[-1] == got[r - 1]


def test_emd_cost_kernel_eval_block_repeats_bit_for_bit(gen):
    """The evaluation's block of 16 x 33 pairs of 2048-point clouds: within
    the gate of the plain version, and the same pair list gives the same
    costs twice (fixed-order sums, no atomics)."""
    from lion_tpu_torch.eval.metrics import block_pairs
    a = _randn(gen, 16, 2048, 3, scale=0.3)
    b = _randn(gen, 33, 2048, 3, scale=0.3)
    pairs = block_pairs(0, 0, 16, 33, "cuda")
    got, ref = _both("emd_cost", a, b, pairs)
    torch.testing.assert_close(got, ref, rtol=EMD_RTOL, atol=EMD_ATOL)
    again = ops.emd_cost(a, b, pairs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("offset", [0.5, 1.5])
def test_emd_cost_kernel_far_from_the_origin(gen, offset):
    """Clouds away from the origin, where the matmul-form d2 cancels
    |p|^2 + |q|^2: every walk forms d2 alike, so the gate holds."""
    a = _randn(gen, 3, 2048, 3, scale=0.3) + offset
    b = _randn(gen, 2, 2048, 3, scale=0.3) + offset
    pairs = torch.tensor([[i, j] for i in range(3) for j in range(2)],
                         dtype=torch.int32, device="cuda")
    got, ref = _both("emd_cost", a, b, pairs)
    torch.testing.assert_close(got, ref, rtol=EMD_RTOL, atol=EMD_ATOL)


def test_emd_cost_kernel_identical_and_permuted_clouds(gen):
    """A cloud against itself and against a permuted copy costs ~0."""
    a = _randn(gen, 2, 2048, 3, scale=0.3)
    perm = torch.randperm(2048, generator=gen, device="cuda")
    b = torch.cat([a[:1], a[1:, perm]]).contiguous()
    pairs = torch.tensor([[0, 0], [1, 1]], dtype=torch.int32, device="cuda")
    got, ref = _both("emd_cost", a, b, pairs)
    torch.testing.assert_close(got, ref, rtol=EMD_RTOL, atol=EMD_ATOL)
    assert float(got.max()) < 1e-3


def test_emd_cost_kernel_refuses_what_it_does_not_take(gen):
    a = _randn(gen, 1, 64, 3)
    pairs = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        ops.emd_cost(a, a, pairs.long())
    with pytest.raises(ValueError, match="emd_cost"):   # beyond shared memory
        big = _randn(gen, 1, 5000, 3)
        ops.emd_cost(big, big, pairs)
    # indices out of range give NaN, not a stray read
    bad = torch.tensor([[0, 0], [1, 0], [0, -1]], dtype=torch.int32,
                       device="cuda")
    out = ops.emd_cost(a, a, bad)
    assert torch.isfinite(out[0]) and torch.isnan(out[1:]).all()


@pytest.mark.parametrize("n,m,k,c,r,dt", [
    (128, 24, 8, 5, 0.2, torch.float32),        # partial balls, M < block
    (300, 50, 64, 3, 0.5, torch.float32),       # K above the hit count
    (2048, 1000, 32, 32, 0.1, torch.float32),   # M off the block's centers
    (50, 5, 64, 2, 2.0, torch.float32),         # K above N
    (2048, 1024, 32, 32, 0.1, BF16),
    (500, 77, 16, 131, 0.3, BF16),              # M odd: staged rows
    (5000, 300, 13, 0, 0.1, BF16),              # beyond one tile; C = 0
    (4100, 37, 32, 192, 0.3, torch.float32)])
def test_ball_query_group_cf_kernel(gen, n, m, k, c, r, dt):
    pts = _randn(gen, 2, n, 3, scale=0.3)
    ctr = pts[:, :m].clone()
    ctr[:, 0] = 5.0                                # an empty ball
    feats = _randn(gen, 2, n, c).to(dt)
    got, ref = _both("ball_query_group_cf", pts, ctr, feats, r, k)
    assert got.dtype == dt and got.shape == (2, k, 3 + c, m)
    # the same indices and the same fp32 subtraction, rounded once
    assert torch.equal(got, ref)
    # the empty ball takes point 0 in every slot
    assert torch.equal(got[:, :, 3:, 0],
                       feats[:, None, 0].expand(-1, k, -1))


@pytest.mark.parametrize("b", [4, 16])
def test_ball_query_group_cf_kernel_at_the_sa_levels(gen, b):
    """K13 at the first three SA levels (the smoke's CF shapes) in fp32 and
    bf16: equal to its plain version and repeating bit for bit."""
    from lion_tpu_torch.profile_step import bqg_level_inputs
    for label, (p, c, f, r, k) in bqg_level_inputs(b, _level_randn(gen))[:3]:
        for dt in (torch.float32, BF16):
            x = f.to(dt)
            got, ref = _both("ball_query_group_cf", p, c, x, r, k)
            assert torch.equal(got, ref), label
            assert torch.equal(got, ops.ball_query_group_cf(p, c, x, r, k))


@pytest.mark.parametrize("cpb,groups,threads", [
    (1, 1, 32), (32, 1, 256), (8, 4, 64), (16, 32, 128), (2, 3, 96)])
def test_ball_query_group_cf_kernel_on_other_plans(gen, cpb, groups,
                                                   threads):
    """Any plan the kernel takes (centers a block, slot groups, threads;
    the cloud in one tile or in tiles of 256 points) gives the plain
    version's output, fp32 and bf16: the staged rows (C = 5, M even and
    odd) and the tiled rows (C = 16, M = 80) where the block allows."""
    from lion_tpu_torch.ops._cuda import ptr, stream_of
    from lion_tpu_torch.ops.points import _r2
    pts = _randn(gen, 2, 900, 3, scale=0.3)
    for m, c in ((78, 5), (77, 5), (80, 16)):
        ctr = pts[:, :m].clone()
        ctr[:, 0] = 5.0
        for dt in (torch.float32, BF16):
            f = _randn(gen, 2, 900, c).to(dt)
            ref = ops.KERNELS["ball_query_group_cf"].plain(pts, ctr, f, 0.2,
                                                           32)
            for tile in (256, 900):
                out = torch.empty(2, 32, 3 + c, m, dtype=dt, device="cuda")
                _with_plan("lion_ball_query_group_cf", ptr(pts), ptr(ctr),
                           ptr(f), ptr(out), 2, 900, m, c, 32, _r2(0.2),
                           int(dt == BF16), cpb, groups, threads, tile,
                           stream_of(pts))
                assert torch.equal(out, ref)


def test_ball_query_group_cf_backward_is_k2s(gen):
    """K13's backward is K2's backward of the permuted gradient, on the
    card, and matches the CPU."""
    pts = _randn(gen, 2, 512, 3, scale=0.3).requires_grad_(True)
    ctr = (pts[:, :64].detach() + 0.01).requires_grad_(True)
    feats = _randn(gen, 2, 512, 16).requires_grad_(True)
    g = _randn(gen, 2, 32, 19, 64)
    (o, gs), (orf, gr) = _grads_on_card_and_cpu(
        lambda p, c, f: ops.ball_query_group_cf(p, c, f, 0.2, 32), pts, ctr,
        feats, grad_out=g)
    assert torch.equal(o, orf) and len(gs) == 3
    (_, g2), _ = _grads_on_card_and_cpu(
        lambda p, c, f: ops.ball_query_group(p, c, f, 0.2, 32), pts, ctr,
        feats, grad_out=g.permute(0, 3, 1, 2))
    # one code on one gradient, every row summed in a fixed order; the
    # points' and features' sums equal the CPU's (ascending r) bit for bit,
    # the centers' (a sum over K) to fp32 rounding
    for i, (a, b, c) in enumerate(zip(gs, gr, g2)):
        assert torch.equal(a, c), i
        if i == 1:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b), i


# -------------------------------------------------------------- stage 1
@pytest.mark.parametrize("r,ci,co", STAGE1_K10_CASES + STAGE1_K10_DX)
def test_conv3d_same_kernel_at_the_stage1_shapes(gen, r, ci, co):
    """K10 at the stage-1 VAE step's shapes at its batch of 32: the style
    encoder's and the encoder's forward convs and the dx of the decoder's
    first conv (Co = 4)."""
    x = _randn(gen, 32, r, r, r, ci)
    w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    got, ref = _both("conv3d_3x3_same", x, w)
    assert got.shape == (32, r, r, r, co)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# (b, r, ci, co) of the weight gradients of the stage-1 step (batch 32)
# and the two-prior step (batch 40), and edge shapes: grids that end inside
# a brick, channel counts past a tile, a single slab
WGRAD_CASES = sorted({k for calls in WGRAD_STEPS.values()
                      for k in calls}) + [
    (2, 5, 7, 9), (1, 12, 48, 96), (3, 2, 3, 4), (2, 7, 192, 3)]


@pytest.mark.parametrize("dt", [torch.float32, BF16])
@pytest.mark.parametrize("b,r,ci,co", WGRAD_CASES)
def test_conv3d_weight_grad_kernel(gen, b, r, ci, co, dt):
    """K10's weight gradient against its plain version (cuDNN's, TF32 off,
    on float32 copies): fp32 sums of b r^3 products in another order, 1e-4
    of the largest entry (their round-off is ~1e-5 of it at b r^3 = 1.3e6);
    bf16: the same float32 sums rounded once, a bf16 ulp apart where the
    orders straddle a rounding."""
    x = _randn(gen, b, r, r, r, ci).to(dt)
    g = _randn(gen, b, r, r, r, co).to(dt)
    got, ref = _both("conv3d_weight_grad", x, g)
    assert got.shape == (3, 3, 3, ci, co) and got.dtype == dt
    if dt == BF16:
        _assert_bf16_close(got, ref, 1e-2)
    else:
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_conv3d_weight_grad_repeats_on_any_stream(gen, dt):
    """The slabs' partials are summed in a fixed order: two calls, and a
    call on a side stream, give the same bits (the stage-1 step's widest
    shape, and its C3 -> 32 conv of eight streams a block)."""
    for b, r, ci, co in ((32, 32, 64, 64), (32, 32, 3, 32)):
        x = _randn(gen, b, r, r, r, ci).to(dt)
        g = _randn(gen, b, r, r, r, co).to(dt)
        first = ops.conv3d_weight_grad(x, g)
        again = ops.conv3d_weight_grad(x, g)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            other = ops.conv3d_weight_grad(x, g)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        assert torch.equal(first, again) and torch.equal(first, other)


def test_conv3d_same_backward_takes_the_kernel_or_raises(gen, monkeypatch):
    """On the card K10's backward never reaches cuDNN's weight gradient:
    with `conv3d_weight` made to raise it still runs, the profiler sees
    only the port's wgrad kernels, and inputs the kernel does not take
    raise."""
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise AssertionError("cuDNN's weight gradient was called")
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight", refuse)
    k = ops.KERNELS["conv3d_weight_grad"]
    before, plain_before = k.launches, k.plain_calls
    x = _randn(gen, 4, 16, 16, 16, 32).requires_grad_(True)
    w = _randn(gen, 3, 3, 3, 32, 64, scale=(27 * 32) ** -0.5)
    w.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.conv3d_3x3_same(x, w).square().sum().backward()
        torch.cuda.synchronize()
    assert k.launches - before == 1 and k.plain_calls == plain_before
    names = {e.key for e in prof.key_averages()}
    wgrad = {n for n in names if "wgrad" in n.lower()}
    assert wgrad and all(n.startswith(("k10_wgrad_tile", "k10_wgrad_sum"))
                         or "::k10_wgrad_" in n for n in wgrad), wgrad
    with pytest.raises(TypeError):
        ops.conv3d_weight_grad(x.detach().half(), x.detach().half())
    with pytest.raises(TypeError):
        ops.conv3d_weight_grad(x.detach(), x.detach().to(BF16))
    with pytest.raises(ValueError):
        ops.conv3d_weight_grad(x.detach(), _randn(gen, 4, 8, 8, 8, 32))


def test_stage1_trainer_takes_two_steps_on_the_card(gen, tmp_path):
    """The flagship VAE's Trainer for two steps at batch 4 on a synthetic
    PointFlow tree: only kernels launch, the losses and parameters stay
    finite, the final checkpoint resumes equal, and eval_nll scores on
    K12."""
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.trainers.hvae_trainer import Trainer
    rs = np.random.RandomState(0)
    for split, count in (("train", 8), ("val", 4), ("test", 4)):
        d = tmp_path / "data" / "03001627" / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"{i}.npy"),
                    (rs.randn(2048, 3) * 0.2).astype(np.float32))
    cfg = flagship_cfg()
    cfg.data.batch_size = cfg.data.batch_size_test = 4
    cfg.ddpm.loss_type = "l1_sum"
    cfg.trainer.epochs = 1
    cfg.viz.viz_freq = 0

    class Args:
        save_dir = str(tmp_path / "exp")
        data_root = str(tmp_path / "data")
    trainer = Trainer(cfg, Args())
    ops.reset_counts()
    trainer.train_epochs()
    results = trainer.eval_nll()
    torch.cuda.synchronize()
    counts = {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}
    for name in ("fps", "ball_query_group", "ball_query", "avg_voxelize",
                 "trilinear_devoxelize", "three_nn_interpolate",
                 "conv3d_3x3_same", "conv3d_3x3_fused", "emd_cost"):
        assert counts[name][0] > 0, (name, counts)
    assert all(p == 0 for _, p in counts.values()), counts
    assert trainer.step == 2
    assert all(torch.isfinite(p).all() for p in trainer.step_fn.params)
    assert np.isfinite([results["MMD-CD"], results["MMD-EMD"]]).all()
    again = Trainer(cfg, Args())
    again.resume(str(tmp_path / "exp" / "checkpoints" / "final.npz"))
    for a, b in zip(again.step_fn.params + again.step_fn.ema.shadow,
                    trainer.step_fn.params + trainer.step_fn.ema.shadow):
        assert torch.equal(a, b)


# -------------------------------------------------------------- stage 2
def test_stage2_trainer_takes_two_steps_on_the_card(gen, tmp_path):
    """The flagship two-prior Trainer for two steps at batch 4 on a
    synthetic PointFlow tree, its VAE from a stage-1 .npz: only kernels
    launch, the losses, parameters and EMA stay finite, the final
    checkpoint resumes equal, eval_sample scores 4 DDIM shapes on K12, and
    the .pt export loads into a LION equal to the EMA."""
    from lion_tpu_torch.ckpt import load_lion_checkpoint
    from lion_tpu_torch.ckpt.io import save_checkpoint, tensors_tree
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.models.vae import VAE
    from lion_tpu_torch.nn.common import init_weights
    from lion_tpu_torch.trainers import get_trainer
    rs = np.random.RandomState(1)
    for split, count in (("train", 8), ("val", 4), ("test", 4)):
        d = tmp_path / "data" / "03001627" / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"{i}.npy"),
                    (rs.randn(2048, 3) * 0.2).astype(np.float32))
    cfg = flagship_cfg()
    cfg.trainer.type = "trainers.train_2prior"
    cfg.data.batch_size = cfg.data.batch_size_test = 4
    cfg.trainer.epochs = 1
    cfg.viz.viz_freq = 0
    cfg.eval_ddim_step = 5
    vae = VAE(cfg)
    init_weights(vae, torch.Generator().manual_seed(3))
    stage1 = str(tmp_path / "stage1.npz")
    save_checkpoint(stage1, {"model": tensors_tree(
        *zip(*vae.named_parameters()))}, {})
    cfg.sde.vae_checkpoint = stage1

    class Args:
        save_dir = str(tmp_path / "exp")
        data_root = str(tmp_path / "data")
    trainer = get_trainer(cfg.trainer.type)(cfg, Args())
    for a, b in zip(trainer.vae.parameters(), vae.parameters()):
        assert torch.equal(a.cpu(), b)
    ops.reset_counts()
    trainer.train_epochs()
    results = trainer.eval_sample(trainer.step, num_gen=4, metric2="EMD")
    torch.cuda.synchronize()
    counts = {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}
    for name in ("fps", "ball_query_group", "ball_query", "avg_voxelize",
                 "trilinear_devoxelize", "three_nn_interpolate",
                 "conv3d_3x3_same", "conv3d_3x3_fused", "emd_cost"):
        assert counts[name][0] > 0, (name, counts)
    assert all(p == 0 for _, p in counts.values()), counts
    assert trainer.step == 2
    step = trainer.step_fn
    assert all(torch.isfinite(p).all() for p in step.params + step.ema.shadow)
    assert np.isfinite(list(results.values())).all()
    again = get_trainer(cfg.trainer.type)(cfg, Args())
    again.resume(str(tmp_path / "exp" / "checkpoints" / "final.npz"))
    for a, b in zip(again.step_fn.params + again.step_fn.ema.shadow,
                    step.params + step.ema.shadow):
        assert torch.equal(a, b)
    path = str(tmp_path / "prior.pt")
    trainer.export_torch(path)
    lion = LION(cfg).load_jax_params(load_lion_checkpoint(path, cfg))
    sd = lion.state_dict()
    for name, e in zip(trainer.param_names, step.ema.shadow):
        assert torch.equal(sd[name], e), name


def test_voxel_ops_take_non_finite_clouds_as_on_the_cpu(gen):
    """A cloud with an infinite coordinate (overflowed latents) normalizes
    to NaN: its points land in voxel (0, 0, 0) and K5 clamps its corners,
    forward and backward, as the plain versions do on the CPU."""
    feats = _randn(gen, 2, 300, 8).requires_grad_(True)
    xyz = _randn(gen, 2, 300, 3)
    xyz[1, 7] = float("inf")

    def run(f, p):
        grid, nc = voxel.voxelize(f, p, 8)
        out = voxel.trilinear_devoxelize(grid * 2.0, nc, 8)
        out.sum().backward()
        return grid, out, f.grad
    got = run(feats, xyz)
    ref = run(feats.detach().cpu().requires_grad_(True), xyz.cpu())
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
    assert not got[0][1].reshape(-1, 8)[1:].any()
    assert torch.isnan(got[1][1]).all()


@pytest.mark.parametrize("r,ci,co", [(8, 16, 32), (16, 32, 32)])
def test_conv3d_same_second_order_matches_plain(gen, r, ci, co):
    """A gradient of a function of K10's input and weight gradients (what
    the Jacobian regularizer differentiates): f = <tanh(conv(x, w)), v>,
    J^T v = df/dx and dw = df/dw by a backward with create_graph, then the
    input's and weight's gradients of |J^T v|^2 + <J^T v, x> + |dw|^2, on
    the card (K10 forward and dx and the weight-gradient kernel, inside
    autograd's record) against the same graph of the plain version."""
    x = _randn(gen, 2, r, r, r, ci)
    w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    v = _randn(gen, 2, r, r, r, co)

    def second_order(conv):
        xx = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        f = (torch.tanh(conv(xx, ww)) * v).sum()
        jtv, gw = torch.autograd.grad(f, (xx, ww), create_graph=True)
        loss = (jtv * jtv).sum() + (jtv * xx).sum() + (gw * gw).sum()
        return torch.autograd.grad(loss, (xx, ww))

    w10 = ops.KERNELS["conv3d_3x3_same"]
    wg = ops.KERNELS["conv3d_weight_grad"]
    before, before_wg = w10.launches, wg.launches
    got = second_order(ops.conv3d_3x3_same)
    # the forward, dx and dw in the first backward; in the second, the dx
    # node's own dx (its cotangent depends on tanh(conv(x, w))), the dw
    # node's two K10 calls (x's and g's gradients), the forward's dx and dw
    assert w10.launches - before >= 6 and wg.launches - before_wg >= 2
    ref = second_order(w10.plain)
    for g, rr in zip(got, ref):
        scale = float(rr.abs().max())
        torch.testing.assert_close(g, rr, rtol=0, atol=1e-4 * scale)


def test_ode_sample_repeats_bit_for_bit(gen):
    """A tiny PF-ODE sample (adaptive dopri5, mixed prediction) on the card
    twice from the same generator seed: the same latents, points and
    evaluations."""
    from lion_tpu_torch.config import get_default_cfg
    from lion_tpu_torch.models import LION
    cfg = get_default_cfg()
    cfg.data.tr_max_sample_points = 64
    cfg.shapelatent.latent_dim = 1
    cfg.shapelatent.encoder_type = "models.latent_points_ada.PointTransPVC"
    cfg.shapelatent.decoder_type = "models.latent_points_ada.LatentPointDecPVC"
    cfg.sde.num_channels_dae = 32
    cfg.sde.num_cell_per_scale_dae = 2
    cfg.sde.embedding_dim = 16
    cfg.tpu.sa_blocks = [[[8, 1, 4], [32, 0.3, 4, [8, 16]]],
                         [[16, 1, 4], [8, 0.5, 4, [16, 16]]],
                         [None, [4, 0.8, 4, [16, 16]]]]
    cfg.tpu.fp_blocks = [[[16, 16], [16, 1, 4]],
                         [[16, 16], [16, 1, 4]],
                         [[16, 8], [8, 1, 4]]]
    cfg.sde.ode_sample = 1
    cfg.sde.mixed_prediction = True
    cfg.sde.ode_solver_tol = 1e-3
    lion = LION(cfg).init_params(torch.Generator().manual_seed(9))
    outs = [lion.sample(3, torch.Generator(device="cuda").manual_seed(4))
            for _ in range(2)]
    assert outs[0]["nfe"] == outs[1]["nfe"] > 0
    for k in ("z_global", "z_local", "points"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert torch.isfinite(outs[0]["points"]).all()


# ------------------------------------------ the fixed-order backward
@pytest.mark.parametrize("b,r,n,c,dt", [
    (4, 32768, 2048, 35, torch.float32),    # K2's backward at SA0
    (4, 32768, 2048, 35, BF16),              # ... on a bf16 gradient
    (2, 16384, 32768, 64, torch.float32),   # K5's backward at r32
    (2, 6144, 1024, 192, torch.float32),    # K6's backward
    (3, 1000, 70000, 8, torch.float32),     # the order beyond shared memory
    (2, 5000, 3, 1, torch.float32),         # crowded buckets, C = 1
    (2, 700, 900, 5, BF16),                 # empty buckets, C % 8 != 0
    (1, 0, 7, 4, torch.float32)])           # no rows: zeros
def test_row_sum_kernel_equals_the_cpu_bit_for_bit(gen, b, r, n, c, dt):
    """The ordered row sum against the plain version (a float32
    scatter_add_) on a CPU copy, which adds in ascending r: bit for bit,
    and twice the same."""
    idx = torch.randint(0, n, (b, r), generator=gen, device="cuda",
                        dtype=torch.int32)
    rows = (_randn(gen, b, r, c) * torch.exp(_randn(gen, b, r, 1) * 3)).to(dt)
    w = ops.KERNELS["row_sum"]
    got = w(idx, rows, n)
    again = w(idx, rows, n)
    ref = w.plain(idx.cpu(), rows.cpu(), n)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert torch.equal(got.cpu(), ref) and torch.equal(got, again)


def test_gather_and_scatter_rows_are_each_others_gradient(gen):
    """gather_rows' gradient is the ordered row sum and the row sum's is the
    gather, to any order: a second derivative through both on the card
    equals the CPU's."""
    x = _randn(gen, 2, 50, 6)
    idx = torch.randint(0, 50, (2, 300), generator=gen, device="cuda")
    v = _randn(gen, 2, 300, 6)

    def run(dev):
        xx = x.to(dev).requires_grad_(True)
        y = ops.gather_rows(torch.tanh(xx), idx.to(dev))
        (gx,) = torch.autograd.grad((y * v.to(dev)).sum(), xx,
                                    create_graph=True)
        s = ops.scatter_rows(idx.to(dev), y * y, 50)
        loss = (gx * gx).sum() + (s * s).sum()
        return torch.autograd.grad(loss, xx)[0]
    got, ref = run("cuda"), run("cpu")
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, run("cuda"))


def _backward_twice(fn, inputs, g):
    """fn's input gradients for cotangent g, twice from the same inputs."""
    outs = []
    for _ in range(2):
        xs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
        grads = torch.autograd.grad(fn(*xs), [t for t in xs
                                              if t.requires_grad], g)
        outs.append(grads)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_point_op_backwards_repeat_bit_for_bit(gen, dt):
    """K2's, K13's, K5's and K6's backwards at the training shapes (batch
    16: SA0, r32 C64, the top FP level), twice on the same gradient: equal
    bit for bit (no float atomics)."""
    from lion_tpu_torch.profile_step import bqg_level_inputs
    b = 16
    _, (p, c, f, r, k) = bqg_level_inputs(b, _level_randn(gen))[0]
    f = f.to(dt)
    g = _randn(gen, b, c.shape[1], k, 3 + f.shape[-1]).to(dt)
    cases = [
        ("ball_query_group", lambda p_, c_, f_: ops.ball_query_group(
            p_, c_, f_, r, k), (p, c, f), g),
        ("ball_query_group_cf", lambda p_, c_, f_: ops.ball_query_group_cf(
            p_, c_, f_, r, k), (p, c, f), g.permute(0, 2, 3, 1).contiguous())]
    nc = voxel.normalize_coords(p, 32).contiguous()
    grid = _randn(gen, b, 32, 32, 32, 64).to(dt)
    cases.append(("trilinear_devoxelize",
                  lambda gg: ops.trilinear_devoxelize(gg, nc, 32), (grid,),
                  _randn(gen, b, p.shape[1], 64).to(dt)))
    cf = _randn(gen, b, c.shape[1], 192).to(dt)
    cases.append(("three_nn_interpolate",
                  lambda f_: ops.nearest_neighbor_interpolate(p, c, f_),
                  (cf,), _randn(gen, b, p.shape[1], 192).to(dt)))
    rs = ops.KERNELS["row_sum"]
    for name, fn, inputs, cot in cases:
        before = rs.launches
        first, second = _backward_twice(fn, inputs, cot)
        assert rs.launches > before, name
        for x, a, bb in zip(inputs, first, second):
            assert a.dtype == x.dtype, name
            assert torch.equal(a, bb), name


@pytest.mark.parametrize("b,r,ci,co,dx", [
    (16, 32, 64, 64, False), (16, 32, 4, 32, False), (16, 16, 128, 64, False),
    (16, 8, 192, 128, False), (16, 32, 64, 64, True), (32, 32, 4, 32, True),
    *((32, r, ci, co, False) for r, ci, co in STAGE1_K10_CASES)])
def test_conv3d_same_bf16_kernel_at_the_training_shapes(gen, b, r, ci, co,
                                                       dx):
    """K10 in bf16 (the brick's wgmma tile without statistics) at the
    training shapes, forward and as dx (the output gradient through the
    flipped, transposed kernel: C32 -> 4 at the outer levels), against its
    plain version (fp32 sums rounded once): within 2e-2 of the output's
    size, a one-ulp rounding apart where the sums' order differs."""
    if dx:
        x = _randn(gen, b, r, r, r, co).to(BF16)
        w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(BF16)
        w = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    else:
        x = _randn(gen, b, r, r, r, ci).to(BF16)
        w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(BF16)
    got, ref = _both("conv3d_3x3_same", x, w)
    assert got.dtype == BF16 and got.shape == ref.shape
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    assert torch.equal(got, ops.KERNELS["conv3d_3x3_same"](x, w))


def test_conv3d_same_bf16_gradients_match_the_cpu(gen):
    """K10's autograd Function in bf16: dx by K10 in bf16, dw by the
    weight-gradient kernel on bf16 x and g, summed in float32 and rounded
    to bf16, against the CPU's plain versions."""
    x = _randn(gen, 2, 16, 16, 16, 32).to(BF16).requires_grad_(True)
    w = _randn(gen, 3, 3, 3, 32, 4, scale=(27 * 32) ** -0.5).to(
        BF16).requires_grad_(True)
    (y, gs), (yr, gr) = _grads_on_card_and_cpu(
        ops.conv3d_3x3_same, x, w,
        grad_out=_randn(gen, 2, 16, 16, 16, 4).to(BF16))
    assert y.dtype == BF16 and [g.dtype for g in gs] == [BF16, BF16]
    for a, b in ((y, yr), *zip(gs, gr)):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


@pytest.mark.parametrize("b", [4, 16])
def test_ball_query_group_bf16_kernel_at_the_sa_levels(gen, b):
    """K2 on bf16 features at the SA levels: its plain version bit for bit,
    the fp32 kernel's rows rounded once, and bf16 features gathered as they
    are."""
    from lion_tpu_torch.profile_step import bqg_level_inputs
    for label, (p, c, f, r, k) in bqg_level_inputs(b, _level_randn(gen)):
        x = f.to(BF16)
        got, ref = _both("ball_query_group", p, c, x, r, k)
        assert got.dtype == BF16 and torch.equal(got, ref), label
        f32 = ops.ball_query_group(p, c, x.float(), r, k)
        assert torch.equal(got, f32.to(BF16)), label


def test_bf16_trainers_train_save_and_resume_into_fp32(gen, tmp_path):
    """The flagship stage-1 Trainer under sde.autocast_train and the
    two-prior Trainer under tpu.bf16, two steps each at batch 4: bf16
    compute (K10 and K2 launched on bf16), fp32 parameters, a resume equal,
    and each checkpoint resumed by an fp32 trainer equal."""
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.trainers import get_trainer
    rs = np.random.RandomState(2)
    for split, count in (("train", 8), ("val", 4), ("test", 4)):
        d = tmp_path / "data" / "03001627" / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"{i}.npy"),
                    (rs.randn(2048, 3) * 0.2).astype(np.float32))

    class Args:
        save_dir = str(tmp_path / "exp1")
        data_root = str(tmp_path / "data")

    def cfg_of(kind, key):
        cfg = flagship_cfg()
        cfg.trainer.type = kind
        cfg.data.batch_size = cfg.data.batch_size_test = 4
        cfg.ddpm.loss_type = "l1_sum"
        cfg.trainer.epochs = 1
        cfg.viz.viz_freq = 0
        cfg.viz.val_freq = 100
        node, leaf = key.split(".")
        setattr(getattr(cfg, node), leaf, True)
        return cfg
    stage1 = None
    for kind, key in (("trainers.hvae_trainer", "sde.autocast_train"),
                      ("trainers.train_2prior", "tpu.bf16")):
        cfg = cfg_of(kind, key)
        if stage1:
            cfg.sde.vae_checkpoint = stage1
        Args.save_dir = str(tmp_path / kind)
        trainer = get_trainer(kind)(cfg, Args())
        assert cfg.tpu.bf16
        ops.reset_counts()
        trainer.train_epochs()
        torch.cuda.synchronize()
        for name in ("conv3d_3x3_same", "ball_query_group",
                     "trilinear_devoxelize", "three_nn_interpolate"):
            assert ops.KERNELS[name].launches_bf16 > 0, (kind, name)
        assert all(w.plain_calls == 0 for w in ops.KERNELS.values())
        step = trainer.step_fn
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
                   for p in step.params + step.ema.shadow)
        final = str(tmp_path / kind / "checkpoints" / "final.npz")
        for bf16 in (True, False):
            cfg2 = cfg_of(kind, key) if bf16 else flagship_cfg()
            if not bf16:
                cfg2.trainer.type = kind
                cfg2.data.batch_size = cfg2.data.batch_size_test = 4
                cfg2.viz.viz_freq = 0
            if stage1:
                cfg2.sde.vae_checkpoint = stage1
            again = get_trainer(kind)(cfg2, Args())
            again.resume(final)
            for a, b in zip(again.step_fn.params + again.step_fn.ema.shadow,
                            step.params + step.ema.shadow):
                assert torch.equal(a, b)
        stage1 = final


# ------------------------------------------------------------------ CLIs
# tests/test_torch_port_cli.py's tiny widths (that file imports JAX): the
# U-Nets of tests/test_trainers.py with the style encoder shrunk, one epoch
# of 2 steps, a snapshot after it, tiny priors and a 5-step chain, 2 DDIM
# steps in the evaluation; no visualizations (the card's machine has no
# matplotlib)
CLI_TINY = [
    "data.tr_max_sample_points", "32", "data.te_max_sample_points", "32",
    "shapelatent.decoder_num_points", "32",
    "data.batch_size", "4", "data.batch_size_test", "4",
    "ddpm.dropout", "0.0", "trainer.epochs", "1", "viz.viz_freq", "0",
    "viz.save_freq", "-1", "viz.val_freq", "-1", "snapshot_min", "0",
    "tpu.sa_blocks",
    "[[[8,1,16],[256,0.2,4,[8,16]]],[null,[128,0.4,4,[16,16]]]]",
    "tpu.fp_blocks", "[[[16,16],[16,1,16]],[[16,8],[8,1,16]]]",
    "tpu.ncenter_mult", "0.03125", "tpu.vres_mult", "0.25",
    "ddpm.num_steps", "5", "sde.num_channels_dae", "16",
    "sde.num_cell_per_scale_dae", "1", "sde.embedding_dim", "8",
    "sde.warmup_epochs", "0", "sde.dropout", "0.0", "eval_ddim_step", "2"]


def _cli_counts():
    torch.cuda.synchronize()
    counts = {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}
    assert all(p == 0 for _, p in counts.values()), counts
    return {n: k for n, (k, _) in counts.items()}


@pytest.fixture(scope="module")
def cli_stage1(gen, tmp_path_factory):
    """`python -m lion_tpu_torch.train_dist` on the card with the overrides
    of lion_tpu_torch/scripts/train_vae.sh (tpu.bf16) and the tiny widths,
    on a synthetic PointFlow tree."""
    from lion_tpu_torch import train_dist
    root = tmp_path_factory.mktemp("cli")
    rs = np.random.RandomState(3)
    for split, count in (("train", 8), ("val", 4)):
        d = root / "data" / "03001627" / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"{i}.npy"),
                    (rs.randn(2048, 3) * 0.2).astype(np.float32))
    scripts = Path(__file__).resolve().parents[1] / "lion_tpu_torch" / \
        "scripts"
    argv = ["--exp_root", str(root / "exp"), "--data_root",
            str(root / "data")] + train_dist.script_overrides(
        str(scripts / "train_vae.sh"), CATE="chair") + CLI_TINY
    ops.reset_counts()
    trainer = train_dist.main(argv)
    return {"root": root, "argv": argv, "trainer": trainer,
            "counts": _cli_counts(), "scripts": scripts}


def test_train_dist_stage1_on_the_card(cli_stage1):
    """Stage 1 trains on the card (K10 and K2 on bf16), writes its
    experiment, and the same command again resumes from the snapshot."""
    from lion_tpu_torch import train_dist
    tr, counts = cli_stage1["trainer"], cli_stage1["counts"]
    assert tr.device.type == "cuda" and tr.cfg.tpu.bf16 and tr.step == 2
    for name in ("fps", "ball_query_group", "ball_query", "avg_voxelize",
                 "trilinear_devoxelize", "three_nn_interpolate",
                 "conv3d_3x3_same", "row_sum"):
        assert counts[name] > 0, (name, counts)
    for name in ("conv3d_3x3_same", "ball_query_group"):
        assert ops.KERNELS[name].launches_bf16 > 0, name
    assert all(torch.isfinite(p).all() for p in tr.step_fn.params)
    d = Path(tr.save_dir)
    assert (d / "cfg.yml").exists() and (d / "metrics.jsonl").exists()
    assert (d / "checkpoints" / "final.npz").exists()
    ops.reset_counts()
    again = train_dist.main(cli_stage1["argv"])
    _cli_counts()
    assert again.save_dir == tr.save_dir and again.step == 4


@pytest.fixture(scope="module")
def cli_stage2(cli_stage1):
    """Stage 2 through the CLI on stage 1's checkpoint (the overrides of
    lion_tpu_torch/scripts/train_prior.sh and the tiny widths), and its
    `.pt` export."""
    import os
    from lion_tpu_torch import train_dist
    root, scripts = cli_stage1["root"], cli_stage1["scripts"]
    vae = os.path.join(cli_stage1["trainer"].ckpt_dir, "final.npz")
    argv = ["--exp_root", str(root / "exp2"), "--data_root",
            str(root / "data")] + train_dist.script_overrides(
        str(scripts / "train_prior.sh"), CATE="chair", VAE_CKPT=vae) + \
        CLI_TINY
    ops.reset_counts()
    trainer = train_dist.main(argv)
    counts = _cli_counts()
    trainer.export_torch(str(root / "lion.pt"))
    return {"root": root, "trainer": trainer, "counts": counts,
            "pt": str(root / "lion.pt")}


def test_train_dist_stage2_and_eval_generation_on_the_card(cli_stage2):
    """Stage 2 on stage 1's checkpoint, then --eval_generation: 4 shapes
    at 2 DDIM steps scored on K12 against ./datasets/test_data/."""
    import os
    from lion_tpu_torch import train_dist
    tr, counts, root = (cli_stage2["trainer"], cli_stage2["counts"],
                        cli_stage2["root"])
    assert tr.step == 2 and tr.cfg.tpu.bf16
    for name in ("fps", "conv3d_3x3_same", "ball_query", "row_sum"):
        assert counts[name] > 0, (name, counts)
    assert all(torch.isfinite(p).all() for p in tr.step_fn.params)
    ref = root / "run" / "datasets" / "test_data"
    ref.mkdir(parents=True)
    rs = np.random.RandomState(4)
    torch.save({"ref": torch.from_numpy(
                    rs.randn(4, 32, 3).astype(np.float32) * 0.2),
                "mean": torch.zeros(4, 1, 3), "std": torch.ones(4, 1, 1)},
               str(ref / "ref_val_chair.pt"))
    cwd = os.getcwd()
    os.chdir(root / "run")
    try:
        ops.reset_counts()
        train_dist.main(["--config", os.path.join(tr.save_dir, "cfg.yml"),
                         "--pretrained", os.path.join(tr.ckpt_dir,
                                                      "final.npz"),
                         "--eval_generation", "--num_samples", "4"])
    finally:
        os.chdir(cwd)
    counts = _cli_counts()
    assert counts["emd_cost"] > 0 and counts["fps"] > 0
    pts = torch.load(os.path.join(tr.save_dir, "eval", "samples.pt"))
    assert pts.shape == (4, 32, 3) and torch.isfinite(pts).all()
    with open(os.path.join(tr.save_dir, "results", "eval_out.csv")) as f:
        assert f.read().splitlines()[1].startswith("chair")


def test_demo_on_the_card(cli_stage2, tmp_path):
    """The demo on the card from the stage-2 trainer's .pt export."""
    import os
    from lion_tpu_torch import demo
    out = str(tmp_path / "s.npz")
    ops.reset_counts()
    demo.main(["--config", os.path.join(cli_stage2["trainer"].save_dir,
                                        "cfg.yml"),
               "--ckpt", cli_stage2["pt"], "--num_samples", "3",
               "--ddim_step", "2", "--out", out])
    counts = _cli_counts()
    assert counts["fps"] > 0 and counts["trilinear_devoxelize"] > 0
    with np.load(out) as got:
        assert got["points"].shape == (3, 32, 3)
        assert all(np.isfinite(got[k]).all() for k in got.files)
