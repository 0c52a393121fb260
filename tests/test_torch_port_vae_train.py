"""The port's stage-1 VAE training against the JAX package on the CPU.

The losses and the KL helpers against `lion_tpu.utils.losses`; the tiny
VAE's `get_loss` against `VAE.get_loss` and one `make_vae_train_step` step
against `lion_tpu.trainers.steps.make_vae_train_step` on the same weights,
x and posterior draws (the standard normals recovered from JAX's
`latent_list`). The JAX step is compiled once for the module; its
gradients are read through an optax transformation that passes them on to
Adam and keeps them as its state. Dropout is 0 wherever the packages are
compared (their random bits differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_vae_train_step as jax_vae_step
from lion_tpu.utils import losses as jlosses

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.config.view import as_view
from lion_tpu_torch.models.vae import VAE
from lion_tpu_torch.nn import init_weights
from lion_tpu_torch.trainers import (kl_weight_schedule, make_vae_train_step,
                                     warmup_cosine_schedule)
from lion_tpu_torch.utils import losses

from test_torch_port_sample import (  # noqa: F401
    one_torch_thread, to_jax_tree)
from test_torch_port_train import (B, N, _flat, _grad_bounds, _port_grads,
                                   _rho, noise, run_in_bf16, set_key,
                                   train_cfg, unet_dtypes)

LOSS_TYPES = ("l1_sum", "mse_sum", "mse", "cd1_sum", "cd1_sum_emd", "cd_sum",
              "chamfer", "l1_cd", "emd", "chamfer_emd")
# the anneal: 100 steps, constant for the first 5, rising over the next 10
TOTAL_ITER = 100
SCHED = (1e-3, 1e-4, 0, 4, 0, 25)     # warmup-cosine, as the trainer's
EMA_DECAY = 0.9


def vae_cfg(cfg):
    """The tiny VAE with the released stage-1 loss, the KL anneal on and an
    EMA decay that moves the copy visibly."""
    cfg = train_cfg(cfg)
    cfg.ddpm.loss_type = "l1_sum"
    cfg.trainer.anneal_kl = 1
    cfg.sde.kl_const_portion_vada = 0.05
    cfg.trainer.opt.ema_decay = EMA_DECAY
    return cfg


# --------------------------------------------------------------- losses
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_loss_fn_and_its_gradient_match_jax(loss_type):
    # cd1_sum on 4 channels: neighbours by xyz, L1 over every channel
    d = 4 if loss_type == "cd1_sum" else 3
    pred = noise(30, B, N, d, scale=0.3)
    target = noise(31, B, N, d, scale=0.3)

    def jfn(p):
        return jnp.sum(jlosses.loss_fn(p, jnp.asarray(target), loss_type, 3,
                                       B, loss_weight_emd=0.5))
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.loss_fn(p, torch.from_numpy(target), loss_type, 3, B,
                         loss_weight_emd=0.5)
    # the reductions: the *_sum types to a scalar, the others one per item
    assert got.shape == jlosses.loss_fn(
        jnp.asarray(pred), jnp.asarray(target), loss_type, 3, B).shape
    got.sum().backward()
    np.testing.assert_allclose(float(got.detach().sum()), float(want),
                               rtol=1e-5)
    g, w = p.grad.numpy(), np.asarray(want_g)
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), loss_type


def test_loss_fn_refuses_an_unknown_type():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="nope"):
        losses.loss_fn(x, x, "nope", 3, 1)


@pytest.mark.parametrize("step", [0, 5, 9, 20])
def test_kl_coeff_matches_jax(step):
    args = (step, 10, 2, 0.3)
    assert losses.kl_coeff(*args) == jlosses.kl_coeff(*args)


@pytest.mark.parametrize("fun", ["equal", "linear", "sqrt", "square"])
def test_kl_balancer_coeff_matches_jax(fun):
    got = losses.kl_balancer_coeff(3, (2, 1, 3), fun)
    want = np.asarray(jlosses.kl_balancer_coeff(3, (2, 1, 3), fun))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kl_coeff,balance", [(0.4, True), (0.4, False),
                                              (1.0, True)])
def test_kl_balancer_matches_jax_in_both_branches(kl_coeff, balance):
    terms = [noise(40 + i, B) ** 2 for i in range(3)]
    alpha = np.array(jlosses.kl_balancer_coeff(3, (1, 1, 1), "square"))

    def jfn(ts):
        kl, coeffs, vals = jlosses.kl_balancer(
            ts, kl_coeff, balance, jnp.asarray(alpha))
        return jnp.sum(kl), (kl, coeffs, vals)
    (_, want), want_g = jax.value_and_grad(jfn, has_aux=True)(
        [jnp.asarray(t) for t in terms])
    ts = [torch.from_numpy(t).requires_grad_(True) for t in terms]
    got = losses.kl_balancer(ts, kl_coeff, balance, torch.from_numpy(alpha))
    got[0].sum().backward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    # the balancing weights carry no gradient
    for t, w in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5)


# ----------------------------------------------------- get_loss and step
@pytest.fixture(scope="module")
def run():
    """The tiny VAE in both packages on one port initialization, JAX's
    get_loss and one JAX step at step 0, and JAX's KL weights at the
    steps either side of the anneal's corners (one compile each)."""
    vae = VAE(vae_cfg(get_default_cfg()))
    init_weights(vae, torch.Generator().manual_seed(7))
    jcfg = vae_cfg(jax_default_cfg())
    jvae = JaxVAE(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(vae))
    x = noise(32, B, N, 3, scale=0.3)
    rng = jax.random.PRNGKey(33)
    rng_s, rng_d = jax.random.split(rng)

    get_loss = jax.jit(lambda p, xx, kw: jvae.apply(
        {"params": p}, xx, kl_weight=kw, method=JaxVAE.get_loss,
        rngs={"sample": rng_s, "dropout": rng_d}))
    kw0 = float(kl_weight_schedule(vae.cfg, TOTAL_ITER)(0))
    out = get_loss(params, jnp.asarray(x), kw0)

    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    opt = optax.chain(capture, joptim.make_optimizer(
        joptim.warmup_cosine_schedule(*SCHED)))
    state = joptim.create_train_state(params, opt, EMA_DECAY)
    step = jax.jit(jax_vae_step(jvae, opt, as_view(jcfg.to_dict()),
                                TOTAL_ITER))
    new_state, metrics = step(state, jnp.asarray(x), rng)
    kl_weights = {s: float(step(state.replace(step=jnp.asarray(s, jnp.int32)),
                                jnp.asarray(x), rng)[1]["print/kl_weight"])
                  for s in (4, 5, 6, 14, 15, 16)}
    return dict(vae=vae, x=x, out=out, kw0=kw0, params=params,
                new_state=new_state, metrics=metrics, kl_weights=kl_weights)


METRIC_KEYS = ("loss", "print/loss_0", "print/kl_pt", "print/kl_feat",
               "print/kl_glb", "print/kl_weight", "msg/kl", "msg/rec")


def test_get_loss_matches_jax(run):
    vae, want = run["vae"], run["out"]
    vae.train()
    got = vae.get_loss(torch.from_numpy(run["x"]), kl_weight=run["kw0"],
                       rho=_rho(want["latent_list"]))
    for k in METRIC_KEYS:
        v = got[k].detach() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    # the reconstruction: encode and decode in train mode
    np.testing.assert_allclose(got["x_0_pred"].detach().numpy(),
                               np.asarray(want["x_0_pred"]), rtol=2e-4,
                               atol=2e-4)
    assert torch.equal(got["x_0_target"], torch.from_numpy(run["x"]))
    assert got["final_pred"] is got["x_0_pred"]
    np.testing.assert_allclose(got["all_eps"].detach().numpy(),
                               np.asarray(want["all_eps"]), rtol=2e-4,
                               atol=2e-4)


def test_vae_step_matches_lion_tpu(run):
    vae = run["vae"]
    step = make_vae_train_step(vae, warmup_cosine_schedule(*SCHED),
                               TOTAL_ITER, device="cpu")
    before = {k: p.detach().clone() for k, p in vae.named_parameters()}
    metrics = step(torch.from_numpy(run["x"]),
                   rho=_rho(run["out"]["latent_list"]))
    want = run["metrics"]
    assert set(metrics) == set(want) == set(METRIC_KEYS)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    new_state = run["new_state"]
    # the gradients: 1e-4 relative L2 over all, 1e-3 on each tensor
    _grad_bounds(_port_grads(vae), _flat(new_state.opt_state[0]))
    # Adam's first step moves each parameter by ~lr * sign(g). Where the
    # gradient is rounding noise (the biases before a GroupNorm, whose true
    # gradient is 0) its sign may differ, and the update by up to 2 lr;
    # every other value is held to lr / 100. The EMA moves by (1 - decay)
    # of the update and is held in proportion: (1 - decay) lr / 100, and
    # (1 - decay) 2 lr where the update's sign may differ
    lr = SCHED[0]
    want_p, want_e = _flat(new_state.params), _flat(new_state.ema_params)
    want_g = _flat(new_state.opt_state[0])
    g_norm = float(torch.cat([g.reshape(-1) for g in want_g.values()])
                   .norm())
    for i, (k, p) in enumerate(vae.named_parameters()):
        d = (p.detach() - want_p[k]).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-6, k
        off = d > 1e-2 * lr
        noise_g = torch.where(off, want_g[k].abs(), 0.0)
        assert float(noise_g.max()) <= 1e-6 * g_norm, k
        moved = ((step.ema.shadow[i] - before[k])
                 - (want_e[k] - before[k])).abs()
        tol = (1.0 - EMA_DECAY) * torch.where(off, 2.0 * lr, 1e-2 * lr) + 1e-7
        assert bool((moved <= tol).all()), (k, float(moved.max()))
    assert step.optimizer.count == int(new_state.step) == 1


def test_kl_weight_anneals_as_lion_tpu(run):
    weight = kl_weight_schedule(run["vae"].cfg, TOTAL_ITER)
    for s, want in run["kl_weights"].items():
        assert weight(s) == want, s
    # constant at kl_const_coeff_vada until step 5, at the max from 15
    assert weight(4) == weight(5) == np.float32(0.7)
    assert weight(6) > weight(5) and weight(15) == weight(16) == 1.0
    cfg = vae_cfg(get_default_cfg())
    cfg.trainer.anneal_kl = 0
    assert kl_weight_schedule(cfg, TOTAL_ITER)(3) == cfg.shapelatent.kl_weight


def test_step_with_dropout_repeats_from_one_generator_seed():
    def one():
        cfg = vae_cfg(get_default_cfg())
        cfg.ddpm.dropout = 0.2
        vae = VAE(cfg)
        init_weights(vae, torch.Generator().manual_seed(8))
        step = make_vae_train_step(vae, lambda i: 1e-3, device="cpu")
        gen = torch.Generator().manual_seed(9)
        x = torch.from_numpy(noise(34, B, N, 3, scale=0.3))
        m = [float(step(x, gen)["loss"]) for _ in range(2)]
        return m, [p.detach().clone() for p in step.params]
    (m1, p1), (m2, p2) = one(), one()
    assert m1 == m2 and all(np.isfinite(m1))
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


# ------------------------------------------------ defaults and refusals
def test_vae_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_vae_train_step(VAE(vae_cfg(get_default_cfg())))


@pytest.mark.parametrize("key,value", [("data.cond_on_cat", True)])
def test_vae_step_raises_on_what_is_not_ported(key, value):
    """Class conditioning (once refused as item J2): the class-conditional
    VAE's step refuses to run without labels, and runs with them (its
    parity with lion_tpu is tests/test_torch_port_cond.py's)."""
    cfg = vae_cfg(get_default_cfg())
    node, leaf = key.split(".")
    setattr(getattr(cfg, node), leaf, value)
    vae = VAE(cfg)
    init_weights(vae, torch.Generator().manual_seed(7))
    step = make_vae_train_step(vae, lambda i: 1e-3, device="cpu")
    x = torch.from_numpy(noise(34, B, N, 3, scale=0.3))
    with pytest.raises(ValueError, match="class_label"):
        step(x, torch.Generator().manual_seed(1))
    metrics = step(x, torch.Generator().manual_seed(1),
                   class_label=torch.tensor([0, 3]))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("key", ["tpu.bf16", "sde.autocast_train"])
def test_vae_step_builds_and_runs_in_bf16_under_the_key(key):
    """bf16 training (once refused): under either key the stage-1 step
    computes the encoder's and the decoder's U-Nets in bf16 and keeps the
    style encoder, the parameters, Adam and the EMA in float32."""
    cfg = set_key(vae_cfg(get_default_cfg()), key)
    vae = VAE(cfg)
    init_weights(vae, torch.Generator().manual_seed(7))
    step = make_vae_train_step(vae, warmup_cosine_schedule(*SCHED),
                               TOTAL_ITER, device="cpu")
    assert unet_dtypes(vae.encoder, vae.decoder) == {torch.bfloat16}
    assert unet_dtypes(vae.style_encoder) == {None}
    x = torch.from_numpy(noise(34, B, N, 3, scale=0.3))
    metrics = run_in_bf16([vae.encoder, vae.decoder], lambda: step(
        x, torch.Generator().manual_seed(3)))
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in step.params + step.ema.shadow)


def test_non_finite_coordinates_go_through_the_voxel_ops_as_in_jax():
    """At random weights a VAE's latents can overflow (sigma = exp(log_sigma)
    beyond float32), and the decoder's normalized coordinates turn NaN.
    The cloud's points then land in voxel (0, 0, 0), as XLA converts NaN
    to 0, K5's corners clamp into the grid, and its outputs and gradients
    turn NaN, as lion_tpu's do, while the other clouds are untouched and
    no index leaves the grid."""
    from lion_tpu.ops import voxel as jvoxel
    from lion_tpu_torch.ops import voxel
    r = 4
    feats = noise(35, B, N, 5)
    xyz = noise(36, B, N, 3)
    xyz[1, 3] = np.inf

    def run(f, p):
        f = torch.from_numpy(f).requires_grad_(True)
        grid, nc = voxel.voxelize(f, torch.from_numpy(p), r)
        out = voxel.trilinear_devoxelize(grid * 2.0, nc, r)
        out.sum().backward()
        return grid.detach(), out.detach(), f.grad

    def jrun(f, p):
        def fn(ff):
            grid, nc = jvoxel.voxelize(ff, jnp.asarray(p), r)
            out = jvoxel.trilinear_devoxelize(grid * 2.0, nc, r)
            return out.sum(), (grid, out)
        (_, (grid, out)), g = jax.value_and_grad(fn, has_aux=True)(
            jnp.asarray(f))
        return grid, out, g
    got, want = run(feats, xyz), jrun(feats, xyz)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, equal_nan=True)
    grid, out, grad = got
    assert grid[1].reshape(-1, 5)[1:].eq(0).all()
    assert torch.isnan(out[1]).all() and torch.isnan(grad[1]).all()
    alone = run(feats[:1].copy(), xyz[:1].copy())
    for a, b in zip(got, alone):
        assert torch.equal(a[:1], b)


def test_flagship_vae_overflows_at_random_weights_as_lion_tpu():
    """The released VAE at full width (2048 points, B = 1) on seed-0 port
    weights crossed to lion_tpu as a flax tree, dropout 0: an N(0, 0.3)
    cloud drives the local posterior's log_sigma to 65, so sigma^2
    overflows float32: the KL is infinite, the decoded cloud and the
    reconstruction loss NaN. Both packages give the same log_sigma, the
    same style KL and the same non-finite terms: the overflow is the
    model's at random weights, not the port's."""
    import __graft_entry__
    from lion_tpu_torch.config import flagship_cfg

    def stage1(cfg):
        cfg.ddpm.loss_type = "l1_sum"
        cfg.ddpm.dropout = 0.0
        cfg.tpu.bf16 = False
        return cfg
    vae = VAE(stage1(flagship_cfg()))
    init_weights(vae, torch.Generator().manual_seed(0))
    jvae = JaxVAE(stage1(__graft_entry__._flagship_cfg()))
    # this cloud's style sigma is ~1200; the posterior draws of key 19
    # take the local log_sigma to 65 in lion_tpu
    x = noise(45, 1, 2048, 3, scale=0.3)
    want = jax.jit(lambda p, xx: jvae.apply(
        {"params": p}, xx, kl_weight=1.0, method=JaxVAE.get_loss,
        rngs={"sample": jax.random.PRNGKey(19),
              "dropout": jax.random.PRNGKey(20)}))(
        to_jax_tree(vae), jnp.asarray(x))
    vae.train()
    with torch.no_grad():
        got = vae.get_loss(torch.from_numpy(x), kl_weight=1.0,
                           rho=_rho(want["latent_list"]))
    # the local encoder sees z_global in the thousands: each log_sigma is
    # held to 1e-3 of its largest magnitude
    for (_, _, ls), (_, _, jls) in zip(got["latent_list"],
                                       want["latent_list"]):
        jls = np.asarray(jls)
        assert np.abs(ls.numpy() - jls).max() <= 1e-3 * np.abs(jls).max()
    ls_local = float(got["latent_list"][1][2].max())
    assert 44.4 < ls_local < 88.7     # sigma finite, sigma^2 beyond float32
    np.testing.assert_allclose(float(got["print/kl_glb"]),
                               float(want["print/kl_glb"]), rtol=1e-4)
    for k in ("print/kl_pt", "print/kl_feat", "msg/kl"):
        assert float(got[k]) == float(want[k]) == np.inf, k
    # the decoded cloud overflows too, and its voxel ops give NaN
    assert np.isnan(np.asarray(want["x_0_pred"])).any()
    assert torch.isnan(got["x_0_pred"]).any()
    for k in ("print/loss_0", "loss"):
        assert np.isnan(float(got[k])) and np.isnan(float(want[k])), k
