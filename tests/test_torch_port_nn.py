"""The port's modules against the JAX package's on CPU, on bridged weights.

Each JAX module is initialized (or traced for its param shapes), its params
cross to the port through `ckpt.from_jax` with a strict load, and the same
numpy inputs go through both. Widths are narrow (the tiny `tpu.sa_blocks`
overrides of the CLI test); tolerances are fp32 with the reason stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models.priors import GlobalPrior as JGlobalPrior
from lion_tpu.models.priors import LocalPrior as JLocalPrior
from lion_tpu.nn.pointnet import PointNetAModule as JAModule
from lion_tpu.nn.pointnet import PointNetFPModule as JFPModule
from lion_tpu.nn.pointnet import PointNetSAModule as JSAModule
from lion_tpu.nn.pvconv import PVConv as JPVConv
from lion_tpu.nn.unet import PVCNN2Unet as JUnet

from lion_tpu_torch.ckpt import state_dict_from_jax
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models.priors import GlobalPrior, LocalPrior
from lion_tpu_torch.nn import (PointNetAModule, PointNetFPModule,
                               PointNetSAModule, PVCNN2Unet, PVConv,
                               init_weights)

from test_torch_port_sample import (  # noqa: F401
    one_torch_thread, assert_same_params, tiny_cfg, to_jax_tree)

B, N, STYLE = 2, 64, 128


def noise(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax(jax.device_get(params)),
                           strict=True)
    return module


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _cloud(seed, n=N):
    return noise(seed, B, n, 3) * 0.3


@pytest.mark.parametrize("ada,attention", [(True, True), (False, False)])
def test_pvconv_eval_flow_matches_jax(ada, attention):
    cin, cout, r = 12, 16, 4
    feats, xyz, style = noise(1, B, N, cin), _cloud(2), noise(3, B, STYLE)
    jm = JPVConv(cout, r, attention=attention, ada=ada, init_scale=0.5)
    args = (jnp.asarray(feats), jnp.asarray(xyz),
            jnp.asarray(style) if ada else None)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    want = jax.jit(jm.apply)(params, *args)
    m = _load(PVConv(cin, cout, r, attention=attention, ada=ada,
                     init_scale=0.5), params["params"]).eval()
    f, x, s = _t(feats, xyz, style)
    with torch.no_grad():
        got = m(f, x, s if ada else None)
    # two 27*C-term convs, the GN fold from their stats and a devoxelize
    _close(got, want, 1e-4)


def test_pvconv_init_draws_the_jax_distributions():
    """Same leaves and shapes as the flax init, the same constants, and
    uniform supports of the same width."""
    jm = JPVConv(32, 4, attention=True, ada=True, init_scale=0.1)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32)), jnp.zeros((1, 16, 3)),
        jnp.zeros((1, STYLE)))["params"])
    m = PVConv(32, 32, 4, attention=True, ada=True, init_scale=0.1)
    init_weights(m, torch.Generator().manual_seed(0))
    assert_same_params(m, params)
    mine = m.state_dict()
    for k, v in state_dict_from_jax(params).items():
        got, v = mine[k].numpy(), v.numpy()
        if k.endswith(("ada.emd.bias", ".scale", "norm.bias")):
            np.testing.assert_array_equal(got, v)         # constant inits
        elif v.size >= 256:
            # uniform(-b, b): the max of >= 256 draws is within 10% of b
            ratio = np.abs(got).max() / np.abs(v).max()
            assert 0.9 < ratio < 1 / 0.9, (k, ratio)


def test_sa_module_matches_jax():
    cin, m_centers, k = 10, 16, 8
    feats, xyz, style = noise(4, B, N, cin), _cloud(5), noise(6, B, STYLE)
    jm = JSAModule(m_centers, 0.3, k, (16, 24), ada=True)
    args = (jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)
    want_f, want_c = jax.jit(jm.apply)(params, *args)
    m = _load(PointNetSAModule(m_centers, 0.3, k, cin, (16, 24), ada=True),
              params["params"]).eval()
    with torch.no_grad():
        got_f, got_c = m(*_t(feats, xyz, style))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # dense layers and GroupNorm over the grouped (B, M, K, C) tensor
    _close(got_f, want_f, 1e-4)


def test_a_module_matches_jax():
    feats, xyz, style = noise(7, B, 8, 6), _cloud(8, 8), noise(9, B, STYLE)
    jm = JAModule((16, 8), ada=True)
    args = (jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), *args)
    want_f, want_c = jax.jit(jm.apply)(params, *args)
    m = _load(PointNetAModule(6, (16, 8), ada=True), params["params"])
    with torch.no_grad():
        got_f, got_c = m(*_t(feats, xyz, style))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    _close(got_f, want_f, 1e-4)


def test_fp_module_matches_jax():
    pts, ctr = _cloud(10), _cloud(11, 16)
    cfeat, skip, style = noise(12, B, 16, 20), noise(13, B, N, 5), \
        noise(14, B, STYLE)
    jm = JFPModule((16, 8), ada=True)
    args = tuple(jnp.asarray(a) for a in (pts, ctr, cfeat, skip, style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), *args)
    want = jax.jit(jm.apply)(params, *args)
    m = _load(PointNetFPModule(25, (16, 8), ada=True), params["params"])
    with torch.no_grad():
        got = m(*_t(pts, ctr, cfeat, skip, style))
    # 3-NN weights from matmul-form distances, then dense + GroupNorm
    _close(got, want, 1e-4)


def test_unet_matches_jax():
    """The spec-driven U-Net with a time embedding: port-initialized
    weights run in both packages (the flax init is only traced)."""
    cfg = tiny_cfg(get_default_cfg(), N)
    to_tuple = (lambda x: tuple(to_tuple(v) for v in x)
                if isinstance(x, list) else x)
    spec = dict(num_classes=4, sa_blocks=to_tuple(cfg.tpu.sa_blocks),
                fp_blocks=to_tuple(cfg.tpu.fp_blocks), embed_dim=16,
                extra_feature_channels=1, input_dim=3, style_dim=STYLE,
                init_scale=0.1)
    x = np.concatenate([_cloud(15), noise(16, B, N, 1)], -1)
    t, style = np.array([3.0, 700.0], np.float32), noise(17, B, STYLE)
    jm = JUnet(**spec, use_att=True, ada=True)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(style))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    m = PVCNN2Unet(**spec).eval()
    init_weights(m, torch.Generator().manual_seed(1))
    assert_same_params(m, shapes["params"])
    want = jax.jit(jm.apply)({"params": to_jax_tree(m)}, *args)
    with torch.no_grad():
        got = m(*_t(x, t, style))
    # the whole U-Net: ~20 dense/conv/norm layers in fp32
    _close(got, want, 2e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_global_prior_matches_jax(mixed):
    x, t = noise(18, B, STYLE), np.array([1.0, 999.0], np.float32)
    jm = JGlobalPrior(STYLE, nf=64, num_blocks=2, embedding_dim=16,
                      mixed_prediction=mixed)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.asarray(x),
                              jnp.asarray(t))
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
    m = _load(GlobalPrior(STYLE, nf=64, num_blocks=2, embedding_dim=16,
                          mixed_prediction=mixed), params["params"]).eval()
    assert (m.mixing_logit is not None) == mixed
    with torch.no_grad():
        got = m(*_t(x, t))
    # a dense ResNet: 2 blocks of 64-wide fp32 matmuls
    _close(got, want, 1e-5)


def test_local_prior_matches_jax():
    cfg, jcfg = tiny_cfg(get_default_cfg(), N), tiny_cfg(jax_default_cfg(), N)
    x = np.concatenate([_cloud(19), noise(20, B, N, 1)], -1).reshape(B, -1)
    t, cond = np.array([10.0, 500.0], np.float32), noise(21, B, STYLE)
    jm = JLocalPrior(jcfg)
    args = (jnp.asarray(x), jnp.asarray(t))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *args, condition_input=jnp.asarray(cond)))
    m = LocalPrior(cfg).eval()
    init_weights(m, torch.Generator().manual_seed(2))
    assert_same_params(m, shapes["params"])
    want = jax.jit(lambda p, a, b, c: jm.apply(p, a, b, condition_input=c))(
        {"params": to_jax_tree(m)}, *args, jnp.asarray(cond))
    with torch.no_grad():
        got = m(*_t(x, t), condition_input=torch.from_numpy(cond))
    assert got.shape == (B, N * 4)
    _close(got, want, 2e-4)
