"""The training slice's ops against the JAX package on CPU: forward and
backward of every op with a gradient, and the plain versions of K10 and K11
against the TPU kernels in interpret mode.

Each op's backward is held against `jax.vjp` of the JAX op on the same
inputs and cotangent. The port runs through the same
`torch.autograd.Function` the card uses, with the plain forward because the
tensors lie on the CPU. Index outputs match exactly; float outputs at fp32
tolerance, stated per test with its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu.ops import interpolate as jinterp
from lion_tpu.ops import points as jpoints
from lion_tpu.ops import voxel as jvoxel
from lion_tpu.ops.pallas.ball_query import ball_query_pallas
from lion_tpu.ops.pallas.conv3d import (_conv3d_pallas_fwd,
                                        _conv3d_pallas_planes)
from lion_tpu.ops.pallas.conv3d import conv3d_3x3_same as jconv_same

from lion_tpu_torch import ops
from lion_tpu_torch.ops import interpolate, points
from lion_tpu_torch.nn.common import group_norm
from lion_tpu_torch.ops.conv3d import _conv3d_3x3_same_plain

from test_torch_port_sample import one_torch_thread  # noqa: F401


def _rs(seed):
    return np.random.RandomState(seed)


def _randn(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(a.copy()).requires_grad_(True)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _flip(w):
    """The dx form's weights: taps flipped, Ci and Co swapped."""
    return np.ascontiguousarray(np.flip(w, (0, 1, 2)).transpose(0, 1, 2, 4,
                                                                 3))


# ------------------------------------------------------------------ K10
@pytest.mark.parametrize("r,ci,co", [(4, 4, 8), (5, 12, 3), (2, 3, 16)])
def test_conv3d_3x3_same_grads_match_jax_vjp(r, ci, co):
    rs = _rs(r * 100 + ci)
    x = _randn(rs, 2, r, r, r, ci)
    w = _randn(rs, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    g = _randn(rs, 2, r, r, r, co)
    want, vjp = jax.vjp(jconv_same, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = _leaf(x), _leaf(w)
    y = ops.conv3d_3x3_same(xt, wt)
    y.backward(torch.from_numpy(g))
    # 27*Ci-term fp32 dot products (27*Co for dx, 2*r^3 for dw) summed in
    # another order
    _close(y, want, 1e-5)
    _close(xt.grad, want_dx, 1e-5)
    _close(wt.grad, want_dw, 1e-4)


@pytest.mark.parametrize("form", ["fwd", "planes"])
def test_conv3d_same_plain_matches_pallas_interpret(form):
    """K10's plain version against the TPU kernel it replaces, on the
    forward and on the dx form (the output gradient through the flipped,
    channel-transposed weights, conv3d.py:589-593)."""
    rs = _rs(5 if form == "fwd" else 8)
    shape = (2, 8, 8, 8, 16) if form == "fwd" else (2, 8, 4, 4, 8)
    co = 8
    x = _randn(rs, *shape)
    w = _randn(rs, 3, 3, 3, shape[-1], co, scale=0.1)
    g = _randn(rs, *shape[:4], co)
    kern = _conv3d_pallas_fwd if form == "fwd" else _conv3d_pallas_planes
    with pltpu.force_tpu_interpret_mode():
        want_y = kern(jnp.asarray(x), jnp.asarray(w), out_dtype=jnp.float32)
        want_dx = kern(jnp.asarray(g), jnp.asarray(_flip(w)),
                       out_dtype=jnp.float32)
    got_y = _conv3d_3x3_same_plain(torch.from_numpy(x), torch.from_numpy(w))
    got_dx = _conv3d_3x3_same_plain(torch.from_numpy(g),
                                    torch.from_numpy(_flip(w)))
    assert got_y.shape == x.shape[:4] + (co,)
    # the TPU kernel sums three packed 9*Ci-wide products per plane; the
    # plain version one 27*Ci-term sum: fp32 rounding of O(1) outputs
    _close(got_y, want_y, 1e-5)
    _close(got_dx, want_dx, 1e-5)


# ------------------------------------------------------------------ K11
@pytest.mark.parametrize("radius,k,m", [(0.5, 8, 16), (0.2, 16, 32),
                                        (1.5, 4, 16)])
def test_ball_query_plain_matches_pallas_interpret_exactly(radius, k, m):
    rs = _rs(1)
    pts = _randn(rs, 2, 128, 3)
    ctr = pts[:, :m].copy()
    ctr[:, 1] = 9.0        # an empty ball
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ball_query_pallas(jnp.asarray(ctr),
                                            jnp.asarray(pts), radius, k))
    want_xla = np.asarray(jpoints.ball_query(jnp.asarray(ctr),
                                             jnp.asarray(pts), radius, k))
    got = ops.ball_query(torch.from_numpy(ctr), torch.from_numpy(pts),
                         radius, k)
    assert got.dtype == torch.int32 and got.shape == (2, m, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_xla)
    hits = (want != want[..., :1]).sum(-1)
    assert (want[:, 1] == 0).all()                   # empty -> all 0
    assert ((hits > 0) & (hits < k - 1)).any() or radius > 1   # partial


@pytest.mark.parametrize("radius,k", [(0.1, 8), (0.25, 16), (0.6, 4)])
def test_ball_query_group_grads_match_jax_vjp(radius, k):
    """Gradients to the features, the point coordinates and the centers,
    with empty, partial and full balls."""
    rs = _rs(3)
    pts = _randn(rs, 2, 128, 3, scale=0.3)
    ctr = pts[:, rs.choice(128, 24, replace=False)].copy()
    ctr[:, 0] = 5.0        # an empty ball: every slot takes point 0
    feats = _randn(rs, 2, 128, 5)
    g = _randn(rs, 2, 24, k, 8)
    want, vjp = jax.vjp(
        lambda p, c, f: jpoints.ball_query_group(p, c, f, radius, k, True),
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(feats))
    want_gp, want_gc, want_gf = vjp(jnp.asarray(g))
    pt, ct, ft = _leaf(pts), _leaf(ctr), _leaf(feats)
    ops.reset_counts()
    out = ops.ball_query_group(pt, ct, ft, radius, k)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    # the backward recomputed the indices with K11 (its plain version here)
    assert ops.KERNELS["ball_query"].plain_calls == 1
    # scatter-adds of up to M*K rows into a point, in another order
    _close(ft.grad, want_gf, 1e-5)
    _close(pt.grad, want_gp, 1e-5)
    _close(ct.grad, want_gc, 1e-5)


# --------------------------------------------------------- K3, K5, K6
@pytest.mark.parametrize("r,c", [(4, 3), (8, 16)])
def test_avg_voxelize_grads_match_jax_vjp(r, c):
    rs = _rs(4)
    feats = _randn(rs, 2, 200, c)
    vox = rs.randint(0, r, (2, 200, 3)).astype(np.int32)
    g = _randn(rs, 2, r, r, r, c)
    want, vjp = jax.vjp(lambda f: jvoxel.avg_voxelize(f, jnp.asarray(vox), r),
                        jnp.asarray(feats))
    (want_gf,) = vjp(jnp.asarray(g))
    ft = _leaf(feats)
    grid = ops.avg_voxelize(ft, torch.from_numpy(vox), r)
    grid.backward(torch.from_numpy(g))
    # the JAX form takes each cell's sum as a difference of running cumsums
    # over the whole cloud, and its transpose runs the cumsums backwards, so
    # its rounding grows with the cloud's total; the port divides once
    _close(grid, want, 2e-5)
    _close(ft.grad, want_gf, 2e-5)


@pytest.mark.parametrize("r,c", [(4, 3), (8, 16)])
def test_trilinear_devoxelize_grads_match_jax_vjp(r, c):
    rs = _rs(5)
    grid = _randn(rs, 2, r, r, r, c)
    nc = rs.uniform(0, r - 1, (2, 150, 3)).astype(np.float32)
    nc[:, :10] = np.floor(nc[:, :10])   # frac == 0: hi collapses onto lo
    nc[:, 10:12] = r - 1                # the grid's far edge
    g = _randn(rs, 2, 150, c)
    want, vjp = jax.vjp(
        lambda gr: jvoxel.trilinear_devoxelize(gr, jnp.asarray(nc), r),
        jnp.asarray(grid))
    (want_gg,) = vjp(jnp.asarray(g))
    gt = _leaf(grid)
    out = ops.trilinear_devoxelize(gt, torch.from_numpy(nc), r)
    out.backward(torch.from_numpy(g))
    _close(out, want, 1e-6)
    # each cell sums the weighted gradients of the points around it, in
    # another order
    _close(gt.grad, want_gg, 1e-5)


@pytest.mark.parametrize("n,m,c", [(200, 64, 7), (50, 2, 4), (30, 1, 3)])
def test_nearest_neighbor_interpolate_grads_match_jax_vjp(n, m, c):
    rs = _rs(6)
    p, ctr = _randn(rs, 2, n, 3, scale=0.3), _randn(rs, 2, m, 3, scale=0.3)
    feats = _randn(rs, 2, m, c)
    g = _randn(rs, 2, n, c)
    want, vjp = jax.vjp(
        lambda f: jinterp.nearest_neighbor_interpolate(
            jnp.asarray(p), jnp.asarray(ctr), f), jnp.asarray(feats))
    (want_gf,) = vjp(jnp.asarray(g))
    ft = _leaf(feats)
    out = ops.nearest_neighbor_interpolate(torch.from_numpy(p),
                                           torch.from_numpy(ctr), ft)
    out.backward(torch.from_numpy(g))
    # distances via the matmul form (dot order may differ): fp32 rounding
    _close(out, want, 1e-5)
    # sums over the points that take a center among their three
    _close(ft.grad, want_gf, 1e-5)


@pytest.mark.parametrize("n,m", [(200, 64), (50, 2)])
def test_three_nn_weights_output_matches_jax(n, m):
    """K6's optional (idx, w) output: the three neighbours of lion_tpu's
    three_nn, exactly, and the weights its interpolation uses."""
    rs = _rs(7)
    p, ctr = _randn(rs, 2, n, 3, scale=0.3), _randn(rs, 2, m, 3, scale=0.3)
    feats = _randn(rs, 2, m, 5)
    want_d, want_i = (np.asarray(a) for a in jinterp.three_nn(
        jnp.asarray(p), jnp.asarray(ctr)))
    d = np.clip(want_d, 1e-10, 1e10)
    d01, d02, d12 = d[..., 0] * d[..., 1], d[..., 0] * d[..., 2], \
        d[..., 1] * d[..., 2]
    inv = 1.0 / (d01 + d02 + d12)
    want_w = np.stack([d12 * inv, d02 * inv, d01 * inv], -1)
    out, idx, w = interpolate.three_nn_interpolate(
        torch.from_numpy(p), torch.from_numpy(ctr), torch.from_numpy(feats),
        with_weights=True)
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_i)
    # JAX takes the distances in the matmul form, the port op by op: they
    # differ in their last bits, and the weight's products and quotient
    # magnify that a few times
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(out, interpolate.three_nn_interpolate(
        torch.from_numpy(p), torch.from_numpy(ctr), torch.from_numpy(feats)),
        rtol=0, atol=0)


def test_backward_of_ball_query_group_needs_no_gradient_to_coords():
    """Only the features require a gradient (the training path's case): the
    backward returns none to the coordinates and still matches."""
    rs = _rs(9)
    pts = _randn(rs, 1, 64, 3, scale=0.3)
    ctr = pts[:, :8].copy()
    feats = _randn(rs, 1, 64, 4)
    ft = _leaf(feats)
    pt, ct = torch.from_numpy(pts), torch.from_numpy(ctr)
    out = points.ball_query_group(pt, ct, ft, 0.3, 4)
    out.sum().backward()
    idx = points.ball_query(ct, pt, 0.3, 4).long().reshape(1, -1)
    want = torch.zeros(1, 64, 4).index_add_(
        1, idx[0], torch.ones(1, idx.shape[1], 4))
    torch.testing.assert_close(ft.grad, want, rtol=0, atol=0)
    assert not pt.requires_grad and pt.grad is None


def test_group_norm_statistics_hold_at_many_rows():
    """GroupNorm over 1024 centers x 32 slots of 32 channels (the style
    encoder's first SA block at full size), against a float64 evaluation:
    the two moments are accumulated in float64, so only the float32
    rounding of the normalized values remains."""
    rs = _rs(10)
    x = (rs.randn(2, 1024, 32, 32) * 0.5 + 3.0).astype(np.float32)
    xg = x.astype(np.float64).reshape(2, -1, 8, 4)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    var = (xg * xg).mean(axis=(1, 3), keepdims=True) - mean * mean
    want = ((xg - mean) / np.sqrt(var + 1e-5)).reshape(x.shape)
    got = group_norm(torch.from_numpy(x), torch.ones(32), torch.zeros(32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
