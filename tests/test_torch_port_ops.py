"""The port's six kernel ops against the JAX package's public ops on CPU.

The same numpy inputs go through `lion_tpu` (its XLA forms, which run on
CPU) and `lion_tpu_torch` (the plain PyTorch versions, which its wrappers
pick for CPU tensors). Index outputs must match exactly; float outputs match
at fp32 tolerance, stated per test with its reason.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lion_tpu.ops import interpolate as jinterp
from lion_tpu.ops import points as jpoints
from lion_tpu.ops import voxel as jvoxel
from lion_tpu.ops.pallas.conv3d import conv3d_3x3_fused as jconv

from lion_tpu_torch import ops
from lion_tpu_torch.ops import interpolate, points, voxel
from lion_tpu_torch.ops.conv3d import conv3d_3x3_fused

from test_torch_port_sample import one_torch_thread  # noqa: F401


def _cloud(seed, b, n, scale=0.3):
    return (np.random.RandomState(seed).randn(b, n, 3) * scale).astype(
        np.float32)


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("seed,b,n,m", [(0, 2, 256, 64), (1, 3, 100, 37),
                                        (2, 1, 64, 64)])
def test_fps_matches_jax_exactly(seed, b, n, m):
    xyz = _cloud(seed, b, n)
    # duplicated points force ties in the running min-distance
    xyz[:, n // 2:n // 2 + 4] = xyz[:, :4]
    want_idx = _np(jpoints.furthest_point_sample_idx(jnp.asarray(xyz), m))
    want_ctr = _np(jpoints.furthest_point_sample(jnp.asarray(xyz), m))
    idx, ctr = ops.fps(torch.from_numpy(xyz), m)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    # the centers are the picked coords themselves, bit for bit
    np.testing.assert_array_equal(ctr.numpy(), want_ctr)
    np.testing.assert_array_equal(
        ctr.numpy(), np.take_along_axis(xyz, want_idx[..., None], axis=1))
    np.testing.assert_array_equal(
        points.furthest_point_sample_idx(torch.from_numpy(xyz), m).numpy(),
        want_idx)


@pytest.mark.parametrize("radius,k", [(0.1, 8), (0.25, 16), (0.6, 4)])
def test_ball_query_group_matches_jax_exactly(radius, k):
    rs = np.random.RandomState(3)
    pts = _cloud(3, 2, 128)
    ctr = pts[:, rs.choice(128, 24, replace=False)].copy()
    ctr[:, 0] = 5.0        # an empty ball: every slot takes point 0
    feats = rs.randn(2, 128, 5).astype(np.float32)
    want = _np(jpoints.ball_query_group(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(feats), radius, k,
        True))
    got = ops.ball_query_group(torch.from_numpy(pts), torch.from_numpy(ctr),
                               torch.from_numpy(feats), radius, k)
    assert got.shape == (2, 24, k, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    want_idx = _np(jpoints.ball_query(jnp.asarray(ctr), jnp.asarray(pts),
                                      radius, k))
    got_idx = points.ball_query(torch.from_numpy(ctr), torch.from_numpy(pts),
                                radius, k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    # the test covers empty, partial and full balls
    hits = (want_idx != want_idx[..., :1]).sum(-1)
    assert (want_idx[:, 0] == 0).all() and (hits == 0).any()


def test_grouping_and_gather_match_jax_exactly():
    rs = np.random.RandomState(10)
    feats = rs.randn(2, 40, 6).astype(np.float32)
    idx3 = rs.randint(0, 40, (2, 7, 5)).astype(np.int32)
    idx2 = rs.randint(0, 40, (2, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        points.grouping(torch.from_numpy(feats), torch.from_numpy(idx3)),
        _np(jpoints.grouping(jnp.asarray(feats), jnp.asarray(idx3))))
    np.testing.assert_array_equal(
        points.gather(torch.from_numpy(feats), torch.from_numpy(idx2)),
        _np(jpoints.gather(jnp.asarray(feats), jnp.asarray(idx2))))


@pytest.mark.parametrize("r,c", [(4, 3), (8, 16)])
def test_voxelize_matches_jax(r, c):
    rs = np.random.RandomState(4)
    xyz = _cloud(4, 2, 200)
    feats = rs.randn(2, 200, c).astype(np.float32)
    want_grid, want_nc = jvoxel.voxelize(jnp.asarray(feats), jnp.asarray(xyz),
                                         r)
    grid, nc = voxel.voxelize(torch.from_numpy(feats), torch.from_numpy(xyz),
                              r)
    # reduction order of the cloud mean and max norm differs: fp32 rounding
    np.testing.assert_allclose(nc.numpy(), _np(want_nc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(torch.round(nc).numpy(),
                                  np.round(_np(want_nc)))
    # the JAX form takes each cell's sum as a difference of running cumsums
    # over the whole cloud, so its rounding grows with the cloud's total
    np.testing.assert_allclose(grid.numpy(), _np(want_grid), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("r,c", [(4, 3), (8, 16)])
def test_trilinear_devoxelize_matches_jax(r, c):
    rs = np.random.RandomState(5)
    grid = rs.randn(2, r, r, r, c).astype(np.float32)
    nc = rs.uniform(0, r - 1, (2, 150, 3)).astype(np.float32)
    nc[:, :10] = np.floor(nc[:, :10])   # frac == 0: hi collapses onto lo
    nc[:, 10:12] = r - 1                # the grid's far edge
    want = _np(jvoxel.trilinear_devoxelize(jnp.asarray(grid), jnp.asarray(nc),
                                           r))
    got = voxel.trilinear_devoxelize(torch.from_numpy(grid),
                                     torch.from_numpy(nc), r)
    # same 8-term sum in the same order; XLA may fuse a multiply-add
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,m,c", [(200, 64, 7), (50, 2, 4), (30, 1, 3)])
def test_three_nn_interpolate_matches_jax(n, m, c):
    rs = np.random.RandomState(6)
    p = _cloud(6, 2, n)
    ctr = _cloud(7, 2, m)
    feats = rs.randn(2, m, c).astype(np.float32)
    want = _np(jinterp.nearest_neighbor_interpolate(
        jnp.asarray(p), jnp.asarray(ctr), jnp.asarray(feats)))
    got = ops.nearest_neighbor_interpolate(
        torch.from_numpy(p), torch.from_numpy(ctr), torch.from_numpy(feats))
    # distances via the matmul form (dot order may differ): fp32 rounding
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    want_d, want_i = jinterp.three_nn(jnp.asarray(p), jnp.asarray(ctr))
    got_d, got_i = interpolate.three_nn(torch.from_numpy(p),
                                        torch.from_numpy(ctr))
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("r,ci,co,affine,swish", [
    (4, 4, 8, False, False), (8, 16, 16, True, True), (4, 12, 8, True, False)])
def test_conv3d_3x3_fused_matches_jax(r, ci, co, affine, swish):
    rs = np.random.RandomState(8)
    x = rs.randn(2, r, r, r, ci).astype(np.float32)
    w = (rs.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci)).astype(np.float32)
    s = rs.uniform(0.5, 1.5, (2, ci)).astype(np.float32) if affine else None
    bb = rs.randn(2, ci).astype(np.float32) if affine else None
    want_y, want_st = jconv(
        jnp.asarray(x), jnp.asarray(w),
        in_scale=None if s is None else jnp.asarray(s),
        in_bias=None if bb is None else jnp.asarray(bb),
        pre_swish=swish, want_stats=True)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    y, st = conv3d_3x3_fused(t(x), t(w), t(s), t(bb), pre_swish=swish)
    # 27*Ci-term fp32 dot products summed in another order
    np.testing.assert_allclose(y.numpy(), _np(want_y), rtol=1e-5, atol=1e-5)
    # sums over r^3 voxels of those outputs
    np.testing.assert_allclose(st.numpy(), _np(want_st), rtol=1e-4,
                               atol=1e-3)


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    ops.reset_counts()
    xyz = torch.from_numpy(_cloud(9, 1, 32))
    ops.fps(xyz, 8)
    assert ops.KERNELS["fps"].plain_calls == 1
    assert all(k.launches == 0 for k in ops.KERNELS.values())
    assert set(ops.KERNELS) == {
        "fps", "ball_query_group", "avg_voxelize", "conv3d_3x3_fused",
        "trilinear_devoxelize", "three_nn_interpolate", "sa_fused",
        "conv3d_pair", "pvconv_block_pair", "conv3d_3x3_same",
        "conv3d_weight_grad", "ball_query", "ball_query_group_cf",
        "emd_cost", "row_sum"}
    for name, k in ops.KERNELS.items():
        assert k.source.startswith("lion_tpu_torch/csrc/")
        # the ordered row sum of the backwards and K10's weight gradient
        # replace no TPU kernel
        assert k.replaces.startswith(
            "none" if name in ("row_sum", "conv3d_weight_grad")
            else "lion_tpu/ops/pallas/")
    ops.reset_counts()
    assert ops.KERNELS["fps"].plain_calls == 0


def test_wrappers_raise_for_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        ops.fps(torch.zeros((1, 8, 3), device="meta"), 4)
