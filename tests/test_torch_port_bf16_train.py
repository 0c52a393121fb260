"""bf16 training's ops and modules against the JAX package on the CPU.

K10's plain version in bf16 (forward, dx, and dw rounded to the kernel's
dtype) against `conv3d_3x3_same`'s VJP in bf16 and its TPU kernel in
interpret mode; K2's plain version on bf16 features against the XLA form
(bit for bit), `ball_query_group_pallas` in interpret mode and the JAX
op's VJP; the
bf16 PVConv and SA train flows with their gradients against `jax.vjp` of
lion_tpu's modules built with a bf16 dtype. Inputs come from a numpy seed
and are rounded to bf16 once, so both sides start from the same values.

bf16 keeps 8 mantissa bits: one rounding is up to 2^-9 relative, and two
implementations that round at different places (the port's norms round
once after the norm and swish, the JAX modules' after the norm and again
after the swish) differ by a few of those per stage. Each bound states
the measured error it holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu.nn.pointnet import PointNetSAModule as JSAModule
from lion_tpu.nn.pvconv import PVConv as JPVConv
from lion_tpu.ops import points as jpoints
from lion_tpu.ops.pallas.ball_query_group import ball_query_group_pallas
from lion_tpu.ops.pallas.conv3d import _conv3d_pallas_fwd
from lion_tpu.ops.pallas.conv3d import conv3d_3x3_same as jconv_same

from lion_tpu_torch import ops
from lion_tpu_torch.ckpt import state_dict_from_jax
from lion_tpu_torch.nn import PointNetSAModule, PVConv
from lion_tpu_torch.nn.common import Conv3dSame

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_train import _flat, _port_grads

BF16 = torch.bfloat16
B, N, STYLE = 2, 64, 128


def _bf16(rs, *shape, scale=1.0):
    """A numpy draw rounded to bf16 once, as float32."""
    a = (rs.randn(*shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(BF16).float().numpy()


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    return t.detach().float().numpy()


def _jnp16(a):
    return jnp.asarray(a, jnp.bfloat16)


# ------------------------------------------------------------------ K10
@pytest.mark.parametrize("r,ci,co", [(4, 4, 8), (5, 12, 4), (4, 32, 4),
                                     (3, 3, 16)])
def test_conv3d_same_bf16_grads_match_jax_vjp(r, ci, co):
    """y, dx (K10 on the bf16 gradient and the flipped kernel) and dw (fp32
    from bf16 x and g, rounded to bf16) against lion_tpu's VJP in bf16."""
    rs = np.random.RandomState(r * 100 + ci)
    x = _bf16(rs, 2, r, r, r, ci)
    w = _bf16(rs, 3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
    g = _bf16(rs, 2, r, r, r, co)
    want, vjp = jax.vjp(jconv_same, _jnp16(x), _jnp16(w))
    want_dx, want_dw = vjp(_jnp16(g))
    assert want.dtype == want_dx.dtype == want_dw.dtype == jnp.bfloat16
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    wt = torch.from_numpy(w).to(BF16).requires_grad_(True)
    ops.reset_counts()
    y = ops.conv3d_3x3_same(xt, wt)
    y.backward(torch.from_numpy(g).to(BF16))
    assert ops.KERNELS["conv3d_3x3_same"].plain_calls == 2   # y and dx
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == BF16
    # the same float32 sums rounded once to bf16, in another order: the
    # rounding lands one bf16 ulp apart where a sum sits near a midpoint
    for got, w_ in ((y, want), (xt.grad, want_dx), (wt.grad, want_dw)):
        got, w_ = _np(got), np.asarray(w_, np.float32)
        np.testing.assert_allclose(got, w_, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w_).max())
        assert rel_l2(got, w_) <= 2e-3


def test_conv3d_same_bf16_plain_matches_pallas_interpret():
    """K10's plain version in bf16 against the TPU kernel it replaces in
    interpret mode, bf16 in and out."""
    rs = np.random.RandomState(9)
    x = _bf16(rs, 2, 8, 8, 8, 16)
    w = _bf16(rs, 3, 3, 3, 16, 8, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = _conv3d_pallas_fwd(_jnp16(x), _jnp16(w), out_dtype=jnp.bfloat16)
    got = ops.KERNELS["conv3d_3x3_same"].plain(
        torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16))
    assert got.dtype == BF16
    # the TPU kernel's f32 sums in another order, one rounding each
    w_ = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), w_, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(w_).max())


def test_modular_conv_gives_its_fp32_kernel_a_bf16_rounded_gradient():
    """Conv3dSame.modular in bf16: the fp32 kernel is cast to bf16, so its
    gradient is dw rounded to bf16 (as lion_tpu's VJP returns it in the
    kernel's dtype), and the bias is added in bf16."""
    rs = np.random.RandomState(3)
    conv = Conv3dSame(8, 6)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(_bf16(rs, 3, 3, 3, 6, 8,
                                                 scale=0.2)))
        conv.bias.copy_(torch.from_numpy(_bf16(rs, 8, scale=0.1)))
    x = torch.from_numpy(_bf16(rs, 2, 4, 4, 4, 6))
    y = conv.modular(x, BF16)
    assert y.dtype == BF16
    y.float().pow(2).sum().backward()
    kg = conv.kernel.grad
    assert kg.dtype == torch.float32
    assert torch.equal(kg, kg.to(BF16).float())       # bf16-representable
    assert torch.equal(conv.bias.grad, conv.bias.grad.to(BF16).float())


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("radius,k,c", [(0.3, 8, 5), (0.5, 16, 13)])
def test_ball_query_group_bf16_matches_pallas_and_its_vjp(radius, k, c):
    """K2's plain version on bf16 features: the TPU kernel in interpret
    mode and the XLA form bit for bit (point - center in fp32 rounded
    once, the features copied); the backward's points and centers
    gradients in fp32 and features gradient in bf16, against jax.vjp."""
    rs = np.random.RandomState(k + c)
    pts = (rs.randn(2, 128, 3) * 0.3).astype(np.float32)
    ctr = pts[:, rs.choice(128, 16, replace=False)].copy()
    ctr[:, 0] = 5.0                 # an empty ball: every slot point 0
    feats = _bf16(rs, 2, 128, c)
    args = (jnp.asarray(pts), jnp.asarray(ctr), _jnp16(feats))
    with pltpu.force_tpu_interpret_mode():
        want_k = ball_query_group_pallas(*args, radius, k)
    want, vjp = jax.vjp(
        lambda p, cc, f: jpoints._ball_query_group_xla(p, cc, f, radius, k,
                                                       True), *args)
    assert want.dtype == want_k.dtype == jnp.bfloat16
    pt = torch.from_numpy(pts).requires_grad_(True)
    ct = torch.from_numpy(ctr).requires_grad_(True)
    ft = torch.from_numpy(feats).to(BF16).requires_grad_(True)
    out = ops.ball_query_group(pt, ct, ft, radius, k)
    assert out.dtype == BF16
    got = _np(out)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    # the TPU kernel gathers by a one-hot matmul: the features exactly, the
    # relative coordinates through its bf16 hi/lo split (a few 1e-6 off
    # before the rounding; the walk tests' 2e-2 for K2's fp32 rows)
    want_k = np.asarray(want_k, np.float32)
    np.testing.assert_array_equal(got[..., 3:], want_k[..., 3:])
    np.testing.assert_allclose(got[..., :3], want_k[..., :3], rtol=2e-2,
                               atol=2e-2)
    g = _bf16(rs, 2, 16, k, 3 + c)
    want_gp, want_gc, want_gf = vjp(_jnp16(g))
    out.backward(torch.from_numpy(g).to(BF16))
    assert pt.grad.dtype == ct.grad.dtype == torch.float32
    assert ft.grad.dtype == BF16 and want_gf.dtype == jnp.bfloat16
    # the coordinates' gradients: fp32 sums of bf16 values, in another order
    np.testing.assert_allclose(_np(pt.grad), np.asarray(want_gp),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ct.grad), np.asarray(want_gc),
                               rtol=1e-5, atol=1e-5)
    # the features': the port sums in fp32 and rounds once; XLA's transpose
    # of a bf16 gather adds in bf16 on the CPU: measured at most 2 bf16
    # ulps of the largest sum
    w_ = np.asarray(want_gf, np.float32)
    np.testing.assert_allclose(_np(ft.grad), w_, rtol=0,
                               atol=2 ** -6 * np.abs(w_).max())


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("ada,attention", [(True, True), (False, False)])
def test_bf16_pvconv_train_flow_matches_jax(ada, attention):
    """The bf16 modular PVConv flow (voxelize, K10 in bf16, GroupNorm /
    AdaGN in fp32 rounded once, dropout 0, SE, devoxelize, the point branch
    and attention in bf16) and its parameter and input gradients against
    jax.vjp of lion_tpu's PVConv with dtype bf16, train=True."""
    cin, cout, r = 12, 16, 4
    rs = np.random.RandomState(1)
    feats = _bf16(rs, B, N, cin)
    xyz = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    style = rs.randn(B, STYLE).astype(np.float32)
    g = _bf16(rs, B, N, cout)
    args = (_jnp16(feats), jnp.asarray(xyz),
            jnp.asarray(style) if ada else None)

    def jax_run(dtype, params=None):
        jm = JPVConv(cout, r, attention=attention, ada=ada, init_scale=0.5,
                     dropout=0.0, dtype=dtype)
        x = args[0].astype(dtype or jnp.float32)
        if params is None:
            params = jax.jit(jm.init)(jax.random.PRNGKey(0), x,
                                      *args[1:])["params"]

        def loss(p, f):
            out = jm.apply({"params": p}, f, *args[1:], train=True)
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return params, out, grads
    params, want, (want_g, want_gf) = jax_run(jnp.bfloat16)
    _, want32, (ref_g, ref_gf) = jax_run(None, params)
    assert want.dtype == jnp.bfloat16
    m = PVConv(cin, cout, r, attention=attention, ada=ada, init_scale=0.5,
               dropout=0.0, dtype=BF16)
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    m.train()
    ft = torch.from_numpy(feats).to(BF16).requires_grad_(True)
    ops.reset_counts()
    out = m(ft, torch.from_numpy(xyz), torch.from_numpy(style) if ada
            else None)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == BF16
    # the two convs' forwards and dx (the features need a gradient)
    assert ops.KERNELS["conv3d_3x3_same"].plain_calls == 4
    assert all(p.grad.dtype == torch.float32 for p in m.parameters())
    _hold_bf16(out, want, want32, _port_grads(m), _flat(want_g),
               _flat(ref_g), ft.grad, want_gf, ref_gf)


def test_bf16_sa_module_train_matches_jax():
    """The bf16 SA block in train mode (FPS, K2 on bf16 features, the
    SharedMLP in bf16, the max over K) and its gradients against jax.vjp
    of lion_tpu's block with dtype bf16."""
    cin, m_centers, k = 10, 16, 8
    rs = np.random.RandomState(5)
    feats = _bf16(rs, B, N, cin)
    xyz = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    style = rs.randn(B, STYLE).astype(np.float32)
    g = _bf16(rs, B, m_centers, 24)
    args = (_jnp16(feats), jnp.asarray(xyz), jnp.asarray(style))

    def jax_run(dtype, params=None):
        jm = JSAModule(m_centers, 0.3, k, (16, 24), ada=True, dtype=dtype)
        x = args[0].astype(dtype or jnp.float32)
        if params is None:
            params = jax.jit(jm.init)(jax.random.PRNGKey(1), x,
                                      *args[1:])["params"]

        def loss(p, f):
            out, _ = jm.apply({"params": p}, f, args[1], args[2], train=True)
            return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return params, out, grads
    params, want, (want_g, want_gf) = jax_run(jnp.bfloat16)
    _, want32, (ref_g, ref_gf) = jax_run(None, params)
    m = PointNetSAModule(m_centers, 0.3, k, cin, (16, 24), ada=True,
                         dtype=BF16)
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    m.train()
    ft = torch.from_numpy(feats).to(BF16).requires_grad_(True)
    ops.reset_counts()
    out, _ = m(ft, torch.from_numpy(xyz), torch.from_numpy(style))
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == BF16 and ft.grad.dtype == BF16
    assert ops.KERNELS["ball_query_group"].plain_calls == 1
    _hold_bf16(out, want, want32, _port_grads(m), _flat(want_g),
               _flat(ref_g), ft.grad, want_gf, ref_gf)


def _flat_rel(got, want):
    keys = sorted(want)
    return rel_l2(torch.cat([got[k].reshape(-1).double() for k in keys]),
                  torch.cat([want[k].reshape(-1).double() for k in keys]))


def _hold_bf16(out, want, want32, grads, want_g, ref_g, gf, want_gf,
               ref_gf):
    """A bf16 module against lion_tpu's bf16 module and its float32 one on
    the same parameters. The forward within the bf16 gate of lion_tpu's
    bf16 path (relative L2 0.03, tests/test_bf16_quality.py:87) of both.
    The gradients (parameters, flattened, and the input features) against
    the float32 reference: within 1e-2 (measured 0.004-0.007), and no
    further from it than lion_tpu's bf16 gradients are. Against lion_tpu's
    bf16 gradients the gap is lion_tpu's own rounding: its bf16 backward
    sums the grouped rows and the norms' gradients in bf16 and lands 0.008
    (PVConv) to 0.035 / 0.055 (SA block: parameters / features) from the
    float32 gradient, where the port, which sums in float32 and rounds
    once, lands 0.004-0.007."""
    assert rel_l2(_np(out), np.asarray(want, np.float32)) <= 0.03
    assert rel_l2(_np(out), np.asarray(want32, np.float32)) <= 0.03
    port_err, jax_err = _flat_rel(grads, ref_g), _flat_rel(want_g, ref_g)
    assert port_err <= 1e-2 and port_err <= jax_err, (port_err, jax_err)
    gf_port = rel_l2(_np(gf), np.asarray(ref_gf))
    gf_jax = rel_l2(np.asarray(want_gf, np.float32), np.asarray(ref_gf))
    assert gf_port <= 1e-2 and gf_port <= gf_jax, (gf_port, gf_jax)
