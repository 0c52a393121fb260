"""The port's bf16 sampling path against the JAX package on CPU.

The plain versions of the bf16 kernels (K7 fused SA, K8 conv pair, K9 PVConv
block, K3-K6 in bf16) are held against the JAX package's TPU kernels in
interpret mode or its XLA ops; the bf16 modules and the full-width local
prior against `lion_tpu` built with `tpu.bf16 = True`. Inputs come from a
numpy seed; every bound states its reason. bf16 keeps 8 mantissa bits, so
one rounding is up to 2^-9 relative, and two implementations that round at
different places differ by a few of those per stage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu.nn.pointnet import PointNetSAModule as JSAModule
from lion_tpu.nn.pvconv import PVConv as JPVConv
from lion_tpu.ops import interpolate as jinterp
from lion_tpu.ops import voxel as jvoxel
from lion_tpu.ops.pallas.conv3d import conv3d_3x3_fused as jconv

from lion_tpu_torch import ops
from lion_tpu_torch.ckpt import state_dict_from_jax
from lion_tpu_torch.nn import PointNetSAModule, PVConv
from lion_tpu_torch.ops import voxel
from lion_tpu_torch.ops.conv3d import conv3d_pair
from lion_tpu_torch.ops.pvblock import pvconv_block_pair
from lion_tpu_torch.ops.sa_fused import sa_fused

from test_torch_port_sample import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16


def _rs(seed):
    return np.random.RandomState(seed)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _bf16_np(a):
    """float32 numpy array rounded to bf16 (the shared input of both)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- (a) K7
@pytest.mark.parametrize("radius", [0.5, 0.05])
def test_sa_fused_plain_matches_the_pallas_kernel(radius):
    """The shapes of tests/test_pallas_kernels.py:192-248: radius 0.05
    leaves most balls with 0-1 points (miss slots replicate slot 0)."""
    from lion_tpu.ops.pallas.sa_fused import pointnet_sa_fused_pallas
    rng = _rs(3)
    b, n, m, c, k = 2, 64, 16, 8, 8
    c1, c2 = 16, 24
    pts = rng.randn(b, n, 3).astype(np.float32)
    ctr = pts[:, :m].copy()
    feats = rng.randn(b, n, c).astype(np.float32)
    w1 = rng.randn(3 + c, c1).astype(np.float32) * 0.3
    b1 = rng.randn(c1).astype(np.float32) * 0.1
    w2 = _bf16_np(rng.randn(c1, c2).astype(np.float32) * 0.3)
    b2 = rng.randn(c2).astype(np.float32) * 0.1
    ca1 = 1.0 + 0.2 * rng.randn(b, c1).astype(np.float32)
    cb1 = 0.2 * rng.randn(b, c1).astype(np.float32)
    ca2 = 1.0 + 0.2 * rng.randn(b, c2).astype(np.float32)
    cb2 = 0.2 * rng.randn(b, c2).astype(np.float32)
    a = np.concatenate([pts, feats], -1) @ w1 + b1
    bc = -(ctr @ w1[:3])

    with pltpu.force_tpu_interpret_mode():
        want = pointnet_sa_fused_pallas(
            jnp.asarray(pts), jnp.asarray(ctr),
            jnp.asarray(np.transpose(a, (0, 2, 1))),
            jnp.asarray(np.transpose(bc, (0, 2, 1))),
            (jnp.asarray(w2.T),), (jnp.asarray(b2[:, None]),),
            (jnp.asarray(ca1), jnp.asarray(ca2)),
            (jnp.asarray(cb1), jnp.asarray(cb2)), radius, k)
    want = np.transpose(_np32(want), (0, 2, 1))
    ops.reset_counts()
    got = sa_fused(_t(pts), _t(ctr), _t(a), _t(bc), [_t(w2, BF16)], [_t(b2)],
                   [_t(ca1), _t(ca2)], [_t(cb1), _t(cb2)], radius, k)
    assert ops.KERNELS["sa_fused"].plain_calls == 1
    assert got.dtype == BF16 and got.shape == (b, m, c2)
    # both run GroupNorm on bf16 activations; near-degenerate groups
    # amplify bf16 noise by 1/sigma, so the JAX test's bounds: a tight bulk
    # and a loose tail
    err = np.abs(got.float().numpy() - want)
    assert np.quantile(err, 0.99) < 5e-2, np.quantile(err, 0.99)
    assert err.max() < 0.5, err.max()


# ---------------------------------------------------------------- (b) K8
def test_conv_pair_plain_matches_the_pallas_kernel():
    """r = 32, C = 64, B = 1: the only shape the TPU pair takes
    (tests/test_conv_packed.py:83-112), fed bf16 activations."""
    from lion_tpu.ops.pallas.conv3d_packed import conv3d_packed_pair
    r, c, b = 32, 64, 1
    rng = _rs(7)
    x = _bf16_np(rng.randn(b, r, r, r, c))
    w0 = _bf16_np(rng.randn(3, 3, 3, c, c) * 0.1)
    w1 = _bf16_np(rng.randn(3, 3, 3, c, c) * 0.1)
    b0 = (0.1 * rng.randn(c)).astype(np.float32)
    ca = (1.0 + 0.1 * rng.randn(b, c)).astype(np.float32)
    cb = (0.1 * rng.randn(b, c)).astype(np.float32)
    want_y, want_st = conv3d_packed_pair(
        jnp.asarray(x.reshape(b, r * r, r * c), jnp.bfloat16),
        jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(ca), jnp.asarray(cb),
        jnp.asarray(w1), r, interpret=True)
    want_y = _np32(want_y).reshape(b, r, r, r, c)
    y, st = conv3d_pair(_t(x, BF16), _t(w0, BF16), _t(b0), _t(ca), _t(cb),
                        _t(w1, BF16))
    assert y.dtype == BF16
    # two convs of 1728-term bf16 products summed in another order, each
    # output rounded to bf16: a rounding flip in y0 moves y1 by an ulp
    scale = np.abs(want_y).max()
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=0,
                               atol=2e-2 * scale)
    # sums over 32768 voxels (the TPU squares in bf16, the port in fp32)
    np.testing.assert_allclose(st.numpy(), _np32(want_st), rtol=2e-3,
                               atol=2e-1)


# ---------------------------------------------------------------- (c) K9
@pytest.mark.parametrize("n", [64, 256])
def test_pvconv_block_plain_matches_the_pallas_kernel(n):
    """r = 8, C = 128 at the FP0/FP1 point counts, with the bounds of
    tests/test_conv_packed.py:164-166 (the TPU kernel builds its voxelize and
    devoxelize weights in bf16)."""
    from lion_tpu.ops.pallas.pvblock import pvconv_block_pair as jblock
    r, c, b = 8, 128, 1
    rng = _rs(9)
    feats = _bf16_np(rng.randn(b, n, c))
    xyz = (rng.randn(b, n, 3) * 0.3).astype(np.float32)
    w0 = _bf16_np(rng.randn(3, 3, 3, c, c) * 0.05)
    w1 = _bf16_np(rng.randn(3, 3, 3, c, c) * 0.05)
    b0 = (0.1 * rng.randn(c)).astype(np.float32)
    ca = (1.0 + 0.1 * rng.randn(b, c)).astype(np.float32)
    cb = (0.1 * rng.randn(b, c)).astype(np.float32)
    nc = voxel.normalize_coords(_t(xyz), r)
    vox = torch.round(nc).to(torch.int32)
    want_pts, want_st = jblock(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(vox.numpy()),
        jnp.asarray(nc.numpy()), jnp.asarray(w0), jnp.asarray(b0),
        jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(w1), r, interpret=True)
    pts, st = pvconv_block_pair(_t(feats, BF16), vox, nc, _t(w0, BF16),
                                _t(b0), _t(ca), _t(cb), _t(w1, BF16), r)
    assert pts.dtype == BF16 and pts.shape == (b, n, c)
    want = _np32(want_pts)
    np.testing.assert_allclose(pts.float().numpy(), want,
                               atol=2e-2 * np.abs(want).max(), rtol=5e-2)
    np.testing.assert_allclose(st.numpy(), _np32(want_st), rtol=2e-2,
                               atol=2e-1)


# ------------------------------------------------------------- (d) K3-K6
def test_bf16_voxelize_and_devoxelize_match_jax():
    r, c = 8, 16
    rng = _rs(4)
    xyz = (rng.randn(2, 300, 3) * 0.3).astype(np.float32)
    feats = _bf16_np(rng.randn(2, 300, c))
    want_grid, want_nc = jvoxel.voxelize(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(xyz), r)
    grid, nc = voxel.voxelize(_t(feats, BF16), _t(xyz), r)
    assert grid.dtype == BF16
    # the same fp32 mean rounded once to bf16; the JAX form's cumsum
    # differences can land on the other side of a rounding boundary
    np.testing.assert_allclose(grid.float().numpy(), _np32(want_grid),
                               rtol=8e-3, atol=1e-6)
    g = _bf16_np(rng.randn(2, r, r, r, c))
    want = jvoxel.trilinear_devoxelize(jnp.asarray(g, jnp.bfloat16),
                                       want_nc, r)
    got = voxel.trilinear_devoxelize(_t(g, BF16), nc, r)
    assert got.dtype == BF16
    # the JAX form adds its 8 bf16 products in bf16 (8 roundings), the port
    # in fp32 (one rounding)
    np.testing.assert_allclose(got.float().numpy(), _np32(want), rtol=0,
                               atol=3e-2 * np.abs(g).max())


def test_bf16_three_nn_interpolate_matches_jax():
    rng = _rs(6)
    p = (rng.randn(2, 200, 3) * 0.3).astype(np.float32)
    ctr = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
    f = _bf16_np(rng.randn(2, 64, 12))
    want = jinterp.nearest_neighbor_interpolate(
        jnp.asarray(p), jnp.asarray(ctr), jnp.asarray(f, jnp.bfloat16))
    got = ops.nearest_neighbor_interpolate(_t(p), _t(ctr), _t(f, BF16))
    assert got.dtype == BF16
    # the same bf16 weights; the JAX form sums the 3 products in bf16
    np.testing.assert_allclose(got.float().numpy(), _np32(want), rtol=0,
                               atol=2e-2 * np.abs(f).max())


@pytest.mark.parametrize("affine", [False, True])
def test_bf16_conv3d_matches_jax(affine):
    r, ci, co = 8, 16, 24
    rng = _rs(8)
    x = _bf16_np(rng.randn(2, r, r, r, ci))
    w = _bf16_np(rng.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci))
    s = rng.uniform(0.5, 1.5, (2, ci)).astype(np.float32) if affine else None
    bb = rng.randn(2, ci).astype(np.float32) if affine else None
    want_y, want_st = jconv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        in_scale=None if s is None else jnp.asarray(s),
        in_bias=None if bb is None else jnp.asarray(bb),
        pre_swish=affine, want_stats=True)
    y, st = ops.conv3d_3x3_fused(
        _t(x, BF16), _t(w, BF16), None if s is None else _t(s),
        None if bb is None else _t(bb), pre_swish=affine)
    assert y.dtype == BF16
    # the same bf16 products with fp32 sums in another order, rounded once
    want_y = _np32(want_y)
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=8e-3,
                               atol=1e-3 * np.abs(want_y).max())
    # the port takes the stats of the rounded y, the JAX CPU route of the
    # fp32 y (the TPU kernels take them rounded, conv3d_packed.py:466-472)
    np.testing.assert_allclose(st.numpy(), _np32(want_st), rtol=1e-2,
                               atol=1e-3 * np.abs(_np32(want_st)).max())
    # and the plain version takes the stats of exactly what it returns
    yf = y.float()
    np.testing.assert_array_equal(
        st.numpy(), torch.stack([yf.sum((1, 2, 3)), (yf * yf).sum((1, 2, 3))],
                                1).numpy())


# -------------------------------------------------------- (e) bf16 modules
def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                           strict=True)
    return module


@pytest.mark.parametrize("r,c,n,kernel", [(8, 128, 256, "pvconv_block_pair"),
                                          (32, 64, 2048, "conv3d_pair")])
def test_bf16_pvconv_matches_lion_tpu(r, c, n, kernel):
    """The two fused shapes: the port runs K9 / K8 (plain versions here),
    lion_tpu on the CPU its K4 chain in bf16."""
    rng = _rs(r)
    feats = (rng.randn(1, n, c)).astype(np.float32)
    xyz = (rng.randn(1, n, 3) * 0.3).astype(np.float32)
    style = rng.randn(1, 128).astype(np.float32)
    jm = JPVConv(c, r, ada=True, init_scale=0.5, dtype=jnp.bfloat16)
    args = (jnp.asarray(feats, jnp.bfloat16), jnp.asarray(xyz),
            jnp.asarray(style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    want = _np32(jax.jit(jm.apply)(params, *args))
    m = _load(PVConv(c, c, r, ada=True, init_scale=0.5, dtype=BF16),
              params["params"]).eval()
    ops.reset_counts()
    with torch.no_grad():
        got = m(_t(feats, BF16), _t(xyz), _t(style))
    assert ops.KERNELS[kernel].plain_calls == 1
    assert got.dtype == BF16
    # bf16 rounding at other places through two convs and a GroupNorm fold
    assert rel_l2(got.float().numpy(), want) <= 0.03


def test_bf16_sa_module_matches_lion_tpu():
    """A fused-gate shape (single branch, K = 32, widths multiples of 8):
    the port runs K7, lion_tpu on the CPU ball-query + SharedMLP in bf16."""
    rng = _rs(5)
    feats = rng.randn(2, 256, 24).astype(np.float32)
    xyz = (rng.randn(2, 256, 3) * 0.3).astype(np.float32)
    style = rng.randn(2, 128).astype(np.float32)
    jm = JSAModule(64, 0.2, 32, (32, 48), ada=True, dtype=jnp.bfloat16)
    args = (jnp.asarray(feats, jnp.bfloat16), jnp.asarray(xyz),
            jnp.asarray(style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    want_f, want_c = jax.jit(jm.apply)(params, *args)
    m = _load(PointNetSAModule(64, 0.2, 32, 24, (32, 48), ada=True,
                               dtype=BF16), params["params"]).eval()
    ops.reset_counts()
    with torch.no_grad():
        got_f, got_c = m(_t(feats, BF16), _t(xyz), _t(style))
    assert ops.KERNELS["sa_fused"].plain_calls == 1
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # the fused form rounds A[p] + bc, lion_tpu the grouped bf16 rows
    assert rel_l2(got_f.float().numpy(), _np32(want_f)) <= 0.03


# ------------------------------------------- (f) the full-width local prior
def test_flagship_local_prior_bf16_matches_lion_tpu_and_fp32():
    """The released local prior at full width (2048 points, B = 1) with
    `tpu.bf16 = True`, on port-initialized weights that cross to lion_tpu
    as a flax tree. The port's bf16 runs K7, K8 and K9 (plain versions)."""
    import __graft_entry__
    from lion_tpu.models.priors import LocalPrior as JLocalPrior
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.models.priors import LocalPrior
    from lion_tpu_torch.nn import init_weights
    from test_torch_port_sample import to_jax_tree
    cfg = flagship_cfg()
    cfg.tpu.bf16 = True
    m16 = LocalPrior(cfg).eval()
    init_weights(m16, torch.Generator().manual_seed(0))
    m32 = LocalPrior(flagship_cfg()).eval()
    m32.load_state_dict(m16.state_dict())
    jcfg = __graft_entry__._flagship_cfg()
    jcfg.tpu.bf16 = True
    rng = _rs(14)
    x = np.concatenate([rng.randn(1, 2048, 3) * 0.3, rng.randn(1, 2048, 1)],
                       -1).astype(np.float32).reshape(1, -1)
    t = np.array([500.0], np.float32)
    cond = rng.randn(1, 128).astype(np.float32)
    jm = JLocalPrior(jcfg)
    want = _np32(jax.jit(lambda p, a, b, c: jm.apply(p, a, b,
                                                     condition_input=c))(
        {"params": to_jax_tree(m16)}, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(cond)))
    ops.reset_counts()
    with torch.no_grad():
        got = m16(_t(x), _t(t), condition_input=_t(cond))
        counts = {k: w.plain_calls for k, w in ops.KERNELS.items()}
        ref32 = m32(_t(x), _t(t), condition_input=_t(cond))
    assert got.dtype == torch.float32 and got.shape == (1, 2048 * 4)
    assert all(counts[k] > 0 for k in ("sa_fused", "conv3d_pair",
                                       "pvconv_block_pair")), counts
    assert counts["ball_query_group"] == 0      # every SA block fuses
    # the JAX package's own gate for bf16 drift (tests/test_bf16_quality.py
    # :87); its bf16-vs-fp32 drift on these weights is 0.026-0.027
    assert rel_l2(got.numpy(), want) <= 0.06
    assert rel_l2(got.numpy(), ref32.numpy()) <= 0.06


def test_bf16_lion_loads_jax_params_and_samples_like_lion_tpu():
    """The weight bridge (ckpt/from_jax.py) in a bf16 LION: params stay
    fp32, so the same flax tree loads strictly, and 5 DDPM steps of both
    priors plus the decode follow lion_tpu's bf16 chain with shared
    noise."""
    from lion_tpu.config import get_default_cfg as jax_default_cfg
    from lion_tpu.models import LION as JaxLION
    from lion_tpu_torch.config import get_default_cfg
    from lion_tpu_torch.models import LION
    from test_torch_port_sample import STEPS, N, tiny_cfg, to_jax_tree
    cfg = tiny_cfg(get_default_cfg(), N, STEPS)
    cfg.tpu.bf16 = True
    jcfg = tiny_cfg(jax_default_cfg(), N, STEPS)
    jcfg.tpu.bf16 = True
    params = to_jax_tree(LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    lion = LION(cfg, device="cpu").load_jax_params(params)
    assert all(p.dtype == torch.float32 for p in lion.parameters())
    jlion = JaxLION(jcfg)
    jlion.params = jax.tree_util.tree_map(jnp.asarray, params)
    rs = _rs(11)
    b = 2
    noise = ((rs.randn(b, 128), rs.randn(STEPS, b, 128)),
             (rs.randn(b, N * 4), rs.randn(STEPS, b, N * 4)))
    noise = jax.tree_util.tree_map(lambda a: a.astype(np.float32), noise)
    want = jlion.sample(num_samples=b, given_noise=jax.tree_util.tree_map(
        jnp.asarray, noise))
    got = lion.sample(b, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, noise))
    # the global prior stays fp32 in both packages
    np.testing.assert_allclose(got["z_global"].numpy(),
                               np.asarray(want["z_global"]), rtol=1e-4,
                               atol=1e-4)
    # the local chain and the decode carry bf16 U-Nets through 5 steps:
    # the JAX package's own gate for bf16 drift end to end
    # (tests/test_bf16_quality.py:87)
    for k in ("z_local", "points"):
        assert got[k].dtype == torch.float32
        assert rel_l2(got[k].numpy(), np.asarray(want[k])) <= 0.06, k
