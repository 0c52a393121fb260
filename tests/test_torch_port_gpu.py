"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the main path does not reach (empty balls, fewer than three
centers, grids whose voxel count is not a multiple of the conv tile, odd
channel counts).

Needs an NVIDIA GPU: every test is marked `gpu` and skips without CUDA.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_gpu.py
"""
import pytest
import torch

from lion_tpu_torch import ops
from lion_tpu_torch.ops import voxel

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("b,n,m", [(3, 100, 37), (2, 2048, 1024),
                                   (1, 4000, 16), (2, 8, 8)])
def test_fps_kernel(gen, b, n, m):
    xyz = _randn(gen, b, n, 3)
    xyz[:, n // 2:n // 2 + 4] = xyz[:, :4]       # ties in the min-distance
    (idx, ctr), (ridx, rctr) = _both("fps", xyz, m)
    assert torch.equal(idx, ridx) and torch.equal(ctr, rctr)


@pytest.mark.parametrize("n,m,k,c,r", [(128, 24, 8, 5, 0.2), (300, 50, 32, 0, 0.5),
                                       (2048, 64, 32, 131, 0.4)])
def test_ball_query_group_kernel(gen, n, m, k, c, r):
    pts = _randn(gen, 2, n, 3, scale=0.3)
    ctr = pts[:, :m].clone()
    ctr[:, 0] = 5.0                                # an empty ball
    feats = _randn(gen, 2, n, c)
    got, ref = _both("ball_query_group", pts, ctr, feats, r, k)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("r,c", [(5, 3), (8, 192), (32, 64)])
def test_voxelize_kernels(gen, r, c):
    xyz = _randn(gen, 2, 700, 3, scale=0.3)
    nc = voxel.normalize_coords(xyz, r).contiguous()
    vox = torch.round(nc).to(torch.int32)
    got, ref = _both("avg_voxelize", _randn(gen, 2, 700, c), vox, r)
    # atomic sums in varying order on both sides
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    grid = _randn(gen, 2, r, r, r, c)
    got, ref = _both("trilinear_devoxelize", grid, nc, r)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("r,ci,co,affine,swish", [
    (5, 4, 32, False, False), (8, 192, 128, True, True),
    (16, 128, 64, False, False), (4, 7, 9, True, False), (3, 16, 70, False, True)])
def test_conv3d_kernel(gen, r, ci, co, affine, swish):
    x = _randn(gen, 2, r, r, r, ci)
    w = _randn(gen, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    s = 1.0 + _randn(gen, 2, ci, scale=0.1) if affine else None
    bb = _randn(gen, 2, ci, scale=0.1) if affine else None
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
