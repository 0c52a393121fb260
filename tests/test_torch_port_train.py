"""The port's two-prior training step against the JAX package on CPU.

Modules in train mode (PVConv's modular flow, the SA block's unfused
branch) and the encoders are held against `lion_tpu` on the same weights
and inputs; the whole tiny step against `lion_tpu.trainers.steps.
make_prior_train_step` on the same params, x and draws, with the JAX
gradients read through an optax transformation that stores them as its
state. Dropout is 0 wherever the two packages are compared (their random
bits differ); its own tests check the masks' semantics.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.nn.pointnet import PointNetSAModule as JSAModule
from lion_tpu.nn.pvconv import PVConv as JPVConv
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_step

from lion_tpu_torch import ops
from lion_tpu_torch.ckpt import state_dict_from_jax
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models import LION
from lion_tpu_torch.nn import PointNetSAModule, PVConv
from lion_tpu_torch.nn.common import Dropout, dropout
from lion_tpu_torch.trainers import (EMA, Optimizer, make_prior_train_step,
                                     prior_loss, warmup_cosine_schedule)
from lion_tpu_torch.trainers.base import map_autocast_train

from test_torch_port_sample import (one_torch_thread,  # noqa: F401
                                    ROOT, assert_same_params,
                                    jax_param_shapes, tiny_cfg, to_jax_tree)

B, N, STYLE = 2, 64, 128


def noise(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def train_cfg(cfg, mixed=False):
    """The tiny LION with the released training objective and no dropout."""
    cfg = tiny_cfg(cfg, N)
    cfg.latent_pts.pvd_mse_loss = 1
    cfg.sde.dropout = 0.0
    cfg.ddpm.dropout = 0.0
    cfg.sde.mixed_prediction = mixed
    # a logit of 0 weighs the prediction and the mixing component equally,
    # so both priors' gradients stay large
    cfg.sde.mixing_logit_init = 0.0
    # The style encoder's fixed specs shrink through the size multipliers:
    # 1024 and 256 centers to 32 and 8, grids of r = 32 and 16 to 8 and 4.
    # At full size, lion_tpu's GroupNorm statistics over 1024 x 32 grouped
    # rows drift ~1e-3 from a float64 evaluation on the CPU, and 64 points
    # leave most of a 32^3 grid empty, so its fused-eval variance cancels
    # to a few digits. The U-Nets' tiny specs are scaled up by the inverse
    # multipliers, so they keep their sizes.
    cfg.tpu.ncenter_mult, cfg.tpu.vres_mult = 1 / 32, 1 / 4
    for conv, sa in cfg.tpu.sa_blocks:
        if conv is not None:
            conv[2] *= 4
        sa[0] *= 32
    for _, conv in cfg.tpu.fp_blocks:
        conv[2] *= 4
    return cfg


def _flat(tree, prefix=""):
    """A JAX param (or gradient) tree as {prefix + dotted name: tensor}."""
    return {prefix + k: v for k, v in
            state_dict_from_jax(jax.device_get(tree)).items()}


def _grad_bounds(got, want):
    """Per tensor |g_port - g_jax| <= 1e-3 |g_jax| + 1e-6 |g_all| (L2
    norms); the flattened gradient within relative L2 1e-4. Returns the
    flat error."""
    assert set(got) == set(want)
    g_all = torch.cat([w.reshape(-1).double() for w in want.values()])
    all_norm = float(g_all.norm())
    for k, w in want.items():
        err = float((got[k].double() - w.double()).norm())
        assert err <= 1e-3 * float(w.double().norm()) + 1e-6 * all_norm, k
    diff = torch.cat([(got[k].double() - want[k].double()).reshape(-1)
                      for k in want])
    rel = float(diff.norm()) / all_norm
    assert rel <= 1e-4, rel
    return rel


def _port_grads(module, prefix=""):
    return {prefix + k: p.grad.detach().clone()
            for k, p in module.named_parameters()}


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("ada,attention", [(True, True), (False, False)])
def test_pvconv_train_flow_matches_jax(ada, attention):
    cin, cout, r = 12, 16, 4
    feats, xyz = noise(1, B, N, cin), noise(2, B, N, 3, scale=0.3)
    style, g = noise(3, B, STYLE), noise(4, B, N, cout)
    jm = JPVConv(cout, r, attention=attention, ada=ada, init_scale=0.5,
                 dropout=0.0)
    args = (jnp.asarray(feats), jnp.asarray(xyz),
            jnp.asarray(style) if ada else None)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]

    def loss(p):
        out = jm.apply({"params": p}, *args, train=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    m = PVConv(cin, cout, r, attention=attention, ada=ada, init_scale=0.5,
               dropout=0.0)
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    m.train()
    ops.reset_counts()
    out = m(*(torch.from_numpy(a) for a in (feats, xyz)),
            torch.from_numpy(style) if ada else None)
    out.backward(torch.from_numpy(g))
    # the modular flow ran on K10 (its plain version here), forward and dx
    assert ops.KERNELS["conv3d_3x3_same"].plain_calls == 3
    assert ops.KERNELS["conv3d_3x3_fused"].plain_calls == 0
    # two 27*C-term convs, two GroupNorms and a devoxelize in fp32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _grad_bounds(_port_grads(m), _flat(want_g))


def test_sa_module_train_matches_jax():
    cin, m_centers, k = 10, 16, 8
    feats, xyz = noise(5, B, N, cin), noise(6, B, N, 3, scale=0.3)
    style, g = noise(7, B, STYLE), noise(8, B, m_centers, 24)
    jm = JSAModule(m_centers, 0.3, k, (16, 24), ada=True)
    args = (jnp.asarray(feats), jnp.asarray(xyz), jnp.asarray(style))
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *args)["params"]

    def loss(p, f):
        out, _ = jm.apply({"params": p}, f, args[1], args[2], train=True)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), (want_g, want_gf) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, args[0])
    m = PointNetSAModule(m_centers, 0.3, k, cin, (16, 24), ada=True)
    m.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    m.train()
    ft = torch.from_numpy(feats).requires_grad_(True)
    ops.reset_counts()
    out, _ = m(ft, torch.from_numpy(xyz), torch.from_numpy(style))
    out.backward(torch.from_numpy(g))
    assert ops.KERNELS["ball_query"].plain_calls == 1
    # dense layers and GroupNorm over the grouped (B, M, K, C) tensor
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _grad_bounds(_port_grads(m), _flat(want_g))
    # the features' gradient: the max over K picks the same slot
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_gf),
                               rtol=1e-4, atol=1e-5)


def _tiny_pair(mixed=False, seed=0):
    """The tiny LION in both packages on the same port-initialized
    weights."""
    lion = LION(train_cfg(get_default_cfg(), mixed),
                device="cpu").init_params(torch.Generator().manual_seed(seed))
    params = to_jax_tree(lion)
    jlion = JaxLION(train_cfg(jax_default_cfg(), mixed))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, params)
    return lion, jlion


def _encode_jax(jlion, x, rng):
    return jax.jit(lambda p, xx, k: jlion.vae.apply(
        {"params": p}, xx, method=JaxVAE.encode, rngs={"sample": k}))(
        jlion.params["vae"], jnp.asarray(x), rng)


def _rho(latent_list):
    """The standard normals behind JAX's posterior samples."""
    return tuple(torch.from_numpy(np.array((z - mu) / jnp.exp(ls)))
                 for z, mu, ls in latent_list)


def test_vae_encode_matches_jax_with_given_rho():
    """PointNetPlusEncoder, PointTransPVC and VAE.encode: mu, log_sigma and
    z of both latents."""
    lion, jlion = _tiny_pair()
    x = noise(9, B, N, 3, scale=0.3)
    want_eps, want_logq, want = _encode_jax(jlion, x,
                                            jax.random.PRNGKey(3))
    with torch.no_grad():
        mu, log_sigma = lion.vae.style_encoder(torch.from_numpy(x))
        eps, log_q, got = lion.vae.encode(torch.from_numpy(x),
                                          rho=_rho(want))
    # the style encoder: two plain SA stages (FPS, ball query, PVConv) in
    # fp32; the latent-points encoder: the whole tiny U-Net
    for (gz, gmu, gls), (wz, wmu, wls) in zip(got, want):
        for a, b in ((gz, wz), (gmu, wmu), (gls, wls)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want[0][1]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(log_sigma.numpy(), np.asarray(want[0][2]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(eps.numpy(), np.asarray(want_eps), rtol=2e-4,
                               atol=2e-4)
    for a, b in zip(log_q, want_logq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)


def test_normal_matches_jax():
    from lion_tpu.models.distributions import Normal as JNormal
    from lion_tpu_torch.models.distributions import Normal
    mu, ls, rho = noise(19, 3, 7), noise(20, 3, 7, scale=0.5), noise(21, 3, 7)
    want = JNormal(jnp.asarray(mu), jnp.asarray(ls))
    got = Normal(torch.from_numpy(mu), torch.from_numpy(ls))
    z, r = got.sample(rho=torch.from_numpy(rho))
    assert torch.equal(r, torch.from_numpy(rho))
    # elementwise fp32 formulas in the same order
    np.testing.assert_allclose(
        z.numpy(), np.asarray(want.sample_given_rho(jnp.asarray(rho))),
        rtol=1e-6, atol=1e-6)
    for a, b in ((got.log_p(z), want.log_p(jnp.asarray(z.numpy()))),
                 (got.kl_to_standard(), want.kl_to_standard())):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    drawn, _ = got.sample(torch.Generator().manual_seed(0))
    assert drawn.shape == (3, 7) and torch.isfinite(drawn).all()


# ---------------------------------------------------------------- step
def _capture_grads():
    """An optax transformation whose update is zero and whose state is the
    gradient it was given: `state.opt_state` then holds JAX's gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.mark.parametrize("mixed", [False, True])
def test_prior_step_matches_lion_tpu(mixed):
    lion, jlion = _tiny_pair(mixed, seed=1)
    jcfg = jlion.cfg
    x = noise(10, B, N, 3, scale=0.3)
    opt = _capture_grads()
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, 0.0)
    step = jax.jit(jax_step(jlion.vae, jlion.global_prior,
                            jlion.local_prior, jlion.diffusion, opt, jcfg))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng)
    # the draws the JAX step made (steps.py:137 and the diffusion's
    # iw_quantities, discrete.py:68-69)
    rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(rng, 5)
    want_eps, _, latent_list = _encode_jax(jlion, x, rng_enc)
    t = (jax.random.uniform(rng_t, (B,)) * jlion.diffusion.num_steps
         ).astype(jnp.int32) + 1
    n0 = jax.random.normal(rng_n0, (B, STYLE))
    n1 = jax.random.normal(rng_n1, (B, want_eps.shape[1] - STYLE))

    loss, got = prior_loss(
        lion, torch.from_numpy(x), rho=_rho(latent_list),
        timestep=torch.from_numpy(np.asarray(t)),
        noise=(torch.from_numpy(np.asarray(n0)),
               torch.from_numpy(np.asarray(n1))))
    loss.backward()
    for k in ("loss", "train/p_loss_0", "train/p_loss_1"):
        np.testing.assert_allclose(float(got[k].detach()),
                                   float(metrics[k]), rtol=1e-5)
    want_g = {**_flat(new_state.opt_state["global_prior"], "global_prior."),
              **_flat(new_state.opt_state["local_prior"], "local_prior.")}
    got_g = {**_port_grads(lion.global_prior, "global_prior."),
             **_port_grads(lion.local_prior, "local_prior.")}
    _grad_bounds(got_g, want_g)
    assert all(p.grad is None for p in lion.vae.parameters())


@pytest.mark.parametrize("weight_decay,grad_clip", [(0.0, -1.0),
                                                    (1e-2, 0.5)])
def test_optimizer_schedule_and_ema_match_optax(weight_decay, grad_clip):
    """Five updates on the same gradient sequence, warmup active, against
    make_optimizer + apply_updates (lion_tpu/trainers/optim.py:57-90)."""
    rs = np.random.RandomState(12)
    shapes = {"a": (5, 3), "b": (7,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    sched_args = (1e-2, 1e-4, 3, 6, 1, 2)   # warmup over the first 3 steps
    jopt = joptim.make_optimizer(joptim.warmup_cosine_schedule(*sched_args),
                                 0.9, 0.99, weight_decay, grad_clip)
    state = joptim.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, init), jopt, 0.9)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    sched = warmup_cosine_schedule(*sched_args)
    opt = Optimizer(params.values(), sched, 0.9, 0.99, weight_decay,
                    grad_clip)
    ema = EMA(params.values(), 0.9)
    for i, g in enumerate(grads):
        assert sched(i) == pytest.approx(
            float(joptim.warmup_cosine_schedule(*sched_args)(i)), rel=1e-7)
        state = joptim.apply_updates(
            state, jax.tree_util.tree_map(jnp.asarray, g), jopt, 0.9)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        ema.update()
        for j, (k, p) in enumerate(params.items()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(state.params[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ema.shadow[j].numpy(),
                                       np.asarray(state.ema_params[k]),
                                       rtol=1e-6, atol=1e-7)
    assert opt.count == int(state.step) == 5


# ------------------------------------------------------------- dropout
def test_dropout_keeps_one_minus_p_and_scales():
    p, n = 0.2, 200_000
    x = torch.ones(n)
    y = dropout(x, p, torch.Generator().manual_seed(0))
    kept = float((y != 0).float().mean())
    # a binomial share: 3 sigma of sqrt(p (1 - p) / n)
    assert abs(kept - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert torch.all((y == 0) | (y == 1.0 / (1 - p)))
    m = Dropout(p)
    m.generator = torch.Generator().manual_seed(0)
    assert torch.equal(m.eval()(x), x)            # eval mode never drops
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(p)(x)                              # no global RNG


def test_step_with_the_same_generator_seed_is_the_same_step():
    """Dropout on (the config's rates): every draw from one generator."""
    def run():
        cfg = train_cfg(get_default_cfg())
        cfg.sde.dropout, cfg.ddpm.dropout = 0.2, 0.1
        lion = LION(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(2))
        step = make_prior_train_step(lion, lambda i: 1e-3, device="cpu")
        x = torch.from_numpy(noise(13, B, N, 3, scale=0.3))
        gen = torch.Generator().manual_seed(5)
        metrics = [step(x, gen) for _ in range(2)]
        return metrics, [p.detach().clone() for p in step.params], step
    (m1, p1, step), (m2, p2, _) = run(), run()
    for a, b in zip(m1, m2):
        assert {k: float(v) for k, v in a.items()} == \
            {k: float(v) for k, v in b.items()}
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.isfinite(p).all() for p in p1)
    assert step.ema is not None and step.optimizer.count == 2


def test_tiny_step_lowers_the_loss_on_one_batch():
    lion = LION(train_cfg(get_default_cfg()), device="cpu").init_params(
        torch.Generator().manual_seed(3))
    step = make_prior_train_step(lion, lambda i: 2e-3, device="cpu")
    x = torch.from_numpy(noise(14, B, N, 3, scale=0.3))
    draws = dict(rho=(torch.from_numpy(noise(15, B, STYLE)),
                      torch.from_numpy(noise(16, B, N * 4))),
                 timestep=torch.tensor([2, 4]),
                 noise=(torch.from_numpy(noise(17, B, STYLE)),
                        torch.from_numpy(noise(18, B, N * 4))))
    losses = [float(step(x, None, **draws)["loss"]) for _ in range(20)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


# ------------------------------------------------------ API and bridge
def test_bridge_loads_the_whole_jax_lion_tree_strictly():
    cfg = train_cfg(get_default_cfg())
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(4))
    tree = to_jax_tree(lion)
    assert {"style_encoder", "encoder", "decoder"} <= set(tree["vae"])
    assert_same_params(lion, jax_param_shapes(
        JaxLION(train_cfg(jax_default_cfg()))))
    other = LION(cfg, device="cpu").load_jax_params(tree)
    for (k, a), (_, b) in zip(lion.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k
    del tree["vae"]["style_encoder"]
    with pytest.raises(RuntimeError, match="style_encoder"):
        LION(cfg, device="cpu").load_jax_params(tree)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without CUDA")
    cfg = train_cfg(get_default_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LION(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_prior_train_step(LION(cfg, device="cpu"))


def unet_dtypes(*modules):
    """The compute dtypes of the PVConv and SA blocks under `modules`."""
    return {m.dtype for mod in modules for m in mod.modules()
            if isinstance(m, (PVConv, PointNetSAModule))}


def run_in_bf16(modules, fn):
    """Run fn() with a forward hook on every PVConv and SA block under
    `modules`; return fn's result after asserting that every block ran and
    returned bf16 (the SA blocks their features)."""
    seen = []

    def hook(mod, args, out):
        seen.append((out[0] if isinstance(out, tuple) else out).dtype)
    handles = [m.register_forward_hook(hook) for mod in modules
               for m in mod.modules()
               if isinstance(m, (PVConv, PointNetSAModule))]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    assert seen and set(seen) == {torch.bfloat16}, set(seen)
    return out


def set_key(cfg, key):
    """Set a bf16 key (tpu.bf16 or sde.autocast_train) and map
    autocast_train onto tpu.bf16 as the trainers do."""
    node, leaf = key.split(".")
    setattr(getattr(cfg, node), leaf, True)
    map_autocast_train(cfg)
    assert cfg.tpu.bf16
    return cfg


@pytest.mark.parametrize("key", ["sde.autocast_train", "tpu.bf16"])
def test_step_builds_and_runs_in_bf16_under_the_key(key):
    """bf16 training (once refused): under either key the two-prior step
    computes the local prior's U-Net in bf16 (its train flow, with K10 and
    K2 on bf16) and keeps float32 parameters, Adam and EMA."""
    cfg = set_key(train_cfg(get_default_cfg()), key)
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    step = make_prior_train_step(lion, lambda i: 1e-3, device="cpu")
    assert unet_dtypes(lion.local_prior, lion.vae.encoder) == {
        torch.bfloat16}
    x = torch.from_numpy(noise(13, B, N, 3, scale=0.3))
    metrics = run_in_bf16([lion.local_prior],
                          lambda: step(x, torch.Generator().manual_seed(5)))
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in step.params + step.ema.shadow)
    assert all(m.dtype == torch.float32 for ms in step.optimizer.moments()
               for m in ms)


def test_trainers_import_leaves_jax_out():
    code = ("import sys, lion_tpu_torch.trainers;"
            "bad = [m for m in ('jax', 'flax', 'optax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
