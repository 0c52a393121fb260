"""bf16 training steps against the JAX package on the CPU: one stage-1 VAE
step (`make_vae_train_step`) and one two-prior step
(`make_prior_train_step`) of the tiny models under `tpu.bf16 = True`, on
the same weights, batch and draws as lion_tpu's bf16 step, in
tests/test_trainers.py:465-505's setting (the style MLP damped by 0.01,
lr 1e-4, clip 1).

lion_tpu's gradients are read through an optax transformation that
passes them on to Adam and keeps them as its state. The float32 step of
the port on the same weights and draws (held to lion_tpu's float32 step
within 1e-4 by test_torch_port_train.py and test_torch_port_vae_train.py)
is the reference both bf16 steps are measured against: the bf16 rounding
of each package moves its gradients away from it, and the two packages
round at different places (the port's norms run in float32 and round once;
lion_tpu's backward sums in bf16 where XLA keeps its activations' dtype).
Each bound states what it holds and what was measured.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_step
from lion_tpu.trainers.steps import make_vae_train_step as jax_vae_step

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.config.view import as_view
from lion_tpu_torch.models import LION
from lion_tpu_torch.models.vae import VAE
from lion_tpu_torch.nn import init_weights
from lion_tpu_torch.profile_step import damp_style_head
from lion_tpu_torch.trainers import (make_prior_train_step,
                                     make_vae_train_step,
                                     warmup_cosine_schedule)

from test_torch_port_sample import (one_torch_thread,  # noqa: F401
                                    to_jax_tree)
from test_torch_port_train import (B, N, STYLE, _encode_jax, _flat, _rho,
                                   noise, run_in_bf16, train_cfg)
from test_torch_port_vae_train import vae_cfg

LR, CLIP = 1e-4, 1.0
TOTAL_ITER = 100


def bf16_cfg(cfg, vae=False):
    """The tiny models under tpu.bf16 with tests/test_trainers.py:465-505's
    lr 1e-4 and gradient clip 1."""
    cfg = vae_cfg(cfg) if vae else train_cfg(cfg)
    cfg.tpu.bf16 = True
    cfg.trainer.opt.lr = LR
    cfg.trainer.opt.grad_clip = CLIP
    cfg.sde.grad_clip_max_norm = CLIP
    return cfg


def _step_with_grads(step, module_names, run):
    """run() a port step; return its metrics and the gradients as they
    reach the optimizer (before its clip, as lion_tpu's are captured)."""
    grads, opt_step = {}, step.optimizer.step

    def snapshot():
        for n, p in module_names:
            grads[n] = p.grad.detach().clone()
        opt_step()
    step.optimizer.step = snapshot
    return run(), grads


def _capture_then_adam(opt_cfg, clip):
    """optax: keep the gradients as the first state, then Adam as the
    port's optimizer runs it (lr LR, trainer.opt's betas and decay)."""
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    return optax.chain(capture, joptim.make_optimizer(
        joptim.warmup_cosine_schedule(LR, LR, 0, 2, 0, 1), opt_cfg.beta1,
        opt_cfg.beta2, opt_cfg.weight_decay, clip))


def _flatten(grads, names):
    return torch.cat([grads[n].reshape(-1).double() for n in names])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _hold(names, bf16, fp32, jax_bf16, moved, jax_moved, loss, jax_loss,
          bounds, lr=LR):
    """The bf16 step against lion_tpu's bf16 step and the float32
    reference; `bounds` = (the losses' relative gap, the share of
    parameters whose update differs by more than lr / 100).

    The gradients: the port's bf16 gradient is no further from the float32
    reference than lion_tpu's bf16 gradient is, and the two bf16
    gradients are no further apart than bf16 moves either of them from the
    reference. At these random weights the gradients are sums of many
    nearly cancelling terms (GroupNorm's, AdaGN's), so the bf16 rounding
    of the terms (2^-9 each) does not cancel and moves both packages'
    gradients by much more than the forward's 0.03 (measured in the
    tests' docstrings); where the gradient is large against that noise,
    both packages agree."""
    loss_tol, flip_tol = bounds
    g, g32, gj = (_flatten(d, names) for d in (bf16, fp32, jax_bf16))
    # the losses: fp32 sums of bf16 predictions against fp32 targets
    assert abs(loss - jax_loss) <= loss_tol * abs(jax_loss), (loss, jax_loss)
    port_err, jax_err, gap = _rel(g, g32), _rel(gj, g32), _rel(g, gj)
    assert port_err <= jax_err, (port_err, jax_err)
    assert gap <= max(port_err, jax_err), (gap, port_err, jax_err)
    # Adam's first step moves each parameter by ~lr sign(g): by up to 2 lr
    # where the packages' gradient signs differ (elements whose gradient is
    # below the bf16 noise), and to lr / 100 elsewhere
    d = torch.cat([(moved[n] - jax_moved[n]).reshape(-1).abs()
                   for n in names])
    assert float(d.max()) <= 2.0 * lr + 1e-6
    flips = float((d > 1e-2 * lr).double().mean())
    assert flips <= flip_tol, flips
    return port_err, jax_err, gap, flips


# ------------------------------------------------------------- stage 1
def _vae_step(vae, x, rho, bf16):
    """One port stage-1 step of a copy of `vae` (in bf16 or fp32) ->
    (metrics, gradients, updated parameters) by name."""
    cfg = bf16_cfg(get_default_cfg(), vae=True)
    cfg.tpu.bf16 = bf16
    m = VAE(cfg)
    m.load_state_dict(vae.state_dict())
    step = make_vae_train_step(
        m, warmup_cosine_schedule(LR, LR, 0, 2, 0, 1), TOTAL_ITER,
        device="cpu")
    def run():
        return step(torch.from_numpy(x), rho=rho)
    metrics, grads = _step_with_grads(
        step, list(m.named_parameters()),
        (lambda: run_in_bf16([m.encoder, m.decoder], run)) if bf16 else run)
    return metrics, grads, {n: p.detach().clone()
                            for n, p in m.named_parameters()}


def test_bf16_vae_step_matches_lion_tpu():
    """One bf16 stage-1 step against lion_tpu's on the same weights, x and
    posterior draws (recovered from lion_tpu's latents). Measured: the
    losses 2.6e-3 apart (bound 5e-3); the flattened gradient 0.100 from
    the float32 reference, where lion_tpu's bf16 gradient is 0.170 from
    it, and 0.130 from lion_tpu's; 16.5% of the parameters' updates
    differ by more than lr / 100 (bound 20%), all within 2 lr."""
    cfg = bf16_cfg(get_default_cfg(), vae=True)
    vae = VAE(cfg)
    init_weights(vae, torch.Generator().manual_seed(7))
    # tests/test_trainers.py:482-491: the random-init style head times
    # 0.01, so that its log sigma does not overflow exp() in either package
    damp_style_head(vae)
    jcfg = bf16_cfg(jax_default_cfg(), vae=True)
    jvae = JaxVAE(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(vae))
    x = noise(32, B, N, 3, scale=0.3)
    rng = jax.random.PRNGKey(33)
    opt = _capture_then_adam(jcfg.trainer.opt, CLIP)
    state = joptim.create_train_state(params, opt, 0.0)
    step = jax.jit(jax_vae_step(jvae, opt, as_view(jcfg.to_dict()),
                                TOTAL_ITER))
    new_state, metrics = step(state, jnp.asarray(x), rng)
    rng_s, rng_d = jax.random.split(rng)
    out = jax.jit(lambda p, xx: jvae.apply(
        {"params": p}, xx, kl_weight=1.0, method=JaxVAE.get_loss,
        rngs={"sample": rng_s, "dropout": rng_d}))(params, jnp.asarray(x))
    rho = _rho(out["latent_list"])
    got, g16, p16 = _vae_step(vae, x, rho, True)
    ref, g32, _ = _vae_step(vae, x, rho, False)
    names = [n for n, _ in vae.named_parameters()]
    _hold(names, g16, g32, _flat(new_state.opt_state[0]), p16,
          _flat(new_state.params), float(got["loss"]),
          float(metrics["loss"]), (5e-3, 0.2))
    # bf16 moves the loss by 2.7e-4 from the float32 step's
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        1e-3 * abs(float(ref["loss"]))
    assert all(p.dtype == torch.float32 for p in p16.values())


# ------------------------------------------------------------- stage 2
def _prior_step(lion, x, draws, bf16):
    cfg = bf16_cfg(get_default_cfg())
    cfg.tpu.bf16 = bf16
    m = LION(cfg, device="cpu")
    m.load_state_dict(lion.state_dict())
    step = make_prior_train_step(
        m, warmup_cosine_schedule(LR, LR, 0, 2, 0, 1), device="cpu")
    def run():
        return step(torch.from_numpy(x), **draws)
    named = [(f"{p}.{n}", t) for p in ("global_prior", "local_prior")
             for n, t in getattr(m, p).named_parameters()]
    metrics, grads = _step_with_grads(
        step, named,
        (lambda: run_in_bf16([m.local_prior], run)) if bf16 else run)
    return metrics, grads, {n: t.detach().clone() for n, t in named}


def test_bf16_prior_step_matches_lion_tpu():
    """One bf16 two-prior step against lion_tpu's on the same weights, x
    and draws (re-made from its key). Measured: the losses 1.3e-2 apart
    (bound 2e-2: the bf16 frozen encode's latents differ by a bf16 ulp
    here and there, and the priors' inputs with them); the flattened
    gradient 1.27 from the float32 reference, where lion_tpu's is 1.36
    from it (the local prior's gradient, of norm 9, is below both
    packages' bf16 noise), and 0.82 from lion_tpu's; 26.6% of the
    parameters' updates differ by more than lr / 100 (bound 30%), all
    within 2 lr."""
    lion = LION(bf16_cfg(get_default_cfg()), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    damp_style_head(lion.vae)
    jcfg = bf16_cfg(jax_default_cfg())
    jlion = JaxLION(jcfg)
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    x = noise(10, B, N, 3, scale=0.3)
    opt = _capture_then_adam(jcfg.trainer.opt, CLIP)
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, 0.0)
    step = jax.jit(jax_step(jlion.vae, jlion.global_prior,
                            jlion.local_prior, jlion.diffusion, opt, jcfg))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng)
    rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(rng, 5)
    want_eps, _, latent_list = _encode_jax(jlion, x, rng_enc)
    t = (jax.random.uniform(rng_t, (B,)) * jlion.diffusion.num_steps
         ).astype(jnp.int32) + 1
    n0 = jax.random.normal(rng_n0, (B, STYLE))
    n1 = jax.random.normal(rng_n1, (B, want_eps.shape[1] - STYLE))
    draws = dict(rho=_rho(latent_list),
                 timestep=torch.from_numpy(np.array(t)),
                 noise=(torch.from_numpy(np.array(n0)),
                        torch.from_numpy(np.array(n1))))
    got, g16, p16 = _prior_step(lion, x, draws, True)
    ref, g32, _ = _prior_step(lion, x, draws, False)
    names = sorted(g16)
    want_g = {**_flat(new_state.opt_state[0]["global_prior"],
                      "global_prior."),
              **_flat(new_state.opt_state[0]["local_prior"],
                      "local_prior.")}
    want_p = {**_flat(new_state.params["global_prior"], "global_prior."),
              **_flat(new_state.params["local_prior"], "local_prior.")}
    _hold(names, g16, g32, want_g, p16, want_p, float(got["loss"]),
          float(metrics["loss"]), (2e-2, 0.3))
    # bf16 moves the loss by 1.3e-3 from the float32 step's
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        5e-3 * abs(float(ref["loss"]))
    assert all(p.dtype == torch.float32 for p in p16.values())
