"""The training steps (port of lion_tpu/trainers/steps.py): the stage-1 VAE
step (`make_vae_train_step`, :27-67) and the stage-2 two-prior step
(`make_prior_train_step`, :71-295, the released path).

One stage-1 step trains the whole VAE in train mode (dropout, the PVConv
modular flow on K10, gradients through K2/K11, K3, K5 and K6): the ELBO of
`VAE.get_loss` with the KL weight annealed on the optimizer's step count,
backward, Adam (with trainer.opt's clip, weight decay and betas) and the
EMA at trainer.opt.ema_decay when ddpm.ema is set. The posterior draws come
from the caller's generator, or are given as `rho`, and so do the dropout
masks.

One stage-2 step, on a `LION` whose VAE is frozen:
  1. the VAE encodes x in eval mode without gradients (the fused eval flow,
     K1-K6) into eps = [z_global, z_local];
  2. one t ~ U{1..T} per item, shared by both priors;
  3. each latent is noised with `sample_q`;
  4. the global and the local prior run in train mode (dropout, the PVConv
     modular flow on K10, gradients through K2/K11, K3, K5 and K6);
  5. mixed prediction where `sde.mixed_prediction` is set;
  6. loss = mean((pred - noise)^2) per latent, summed over the two;
  7. backward; Adam on the warmup-cosine schedule; the EMA; the
     `bound_mlogit` clamp of both mixing logits.

Every random number (the encoder's posterior noise, t, the two diffusion
noises, every dropout mask) comes from the `torch.Generator` the caller
passes; the step hands it to the Dropout modules of both priors
(`set_dropout_generator`). Any of the first four may be given instead, so a
test can feed both packages the same numbers. Float32 matmuls and cuDNN
convolutions run in full float32 inside the step (`no_tf32`), whatever the
global flags say.

Not ported, each raising NotImplementedError: continuous diffusion and the
weighted objective with its SN / Jacobian / kinetic regularizers
(`pvd_mse_loss = 0`; ROADMAP Queue 1 item D), class and CLIP conditioning
(item J), bf16 training (item G; the stage-1 step's refusals keep the
older numbers, items 10 and 12).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config.view import as_view
from ..diffusion.discrete import get_mixed_prediction
from ..models.lion import LION, resolve_device
from ..models.vae import VAE
from ..nn.common import set_dropout_generator
from ..ops._cuda import no_tf32
from .optim import EMA, Optimizer, warmup_cosine_schedule


def check_supported(cfg) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for what the
    port's stage-2 steps do not run."""
    cfg = as_view(cfg)
    if cfg.sde.ode_sample:
        raise NotImplementedError(
            "continuous diffusion (sde.ode_sample, the PF-ODE) is not ported "
            "(ROADMAP Queue 1 item D)")
    if not cfg.latent_pts.pvd_mse_loss:
        raise NotImplementedError(
            "the weighted objective with SN / Jacobian / kinetic "
            "regularizers (pvd_mse_loss = 0) is not ported (ROADMAP Queue 1 "
            "item D)")
    if cfg.data.cond_on_cat or cfg.clipforge.enable:
        raise NotImplementedError("class and CLIP conditioning are not "
                                  "ported (ROADMAP Queue 1 item J)")
    if cfg.sde.autocast_train or ("tpu" in cfg and cfg.tpu.bf16):
        raise NotImplementedError("bf16 training is not ported (ROADMAP "
                                  "Queue 1 item G)")


def check_vae_supported(cfg) -> None:
    """Raise NotImplementedError for what the port's VAE step does not
    run."""
    cfg = as_view(cfg)
    if cfg.data.cond_on_cat:
        raise NotImplementedError("class conditioning is not ported "
                                  "(ROADMAP Queue 1 item 12)")
    if cfg.sde.autocast_train or ("tpu" in cfg and cfg.tpu.bf16):
        raise NotImplementedError("bf16 training is not ported (ROADMAP "
                                  "Queue 1 item 10)")


def kl_weight_schedule(cfg, num_total_iter: int) -> Callable[[int], float]:
    """The KL weight at an optimizer step (lion_tpu/trainers/steps.py:
    38-45): with trainer.anneal_kl over num_total_iter > 0 steps,
    min + (max - min) (step - const) / total clipped to [min, max] in
    float32, with total and const the sde.kl_anneal_portion_vada and
    kl_const_portion_vada shares of the steps; else shapelatent.kl_weight."""
    cfg = as_view(cfg)
    if not (cfg.trainer.anneal_kl and num_total_iter > 0):
        weight = cfg.shapelatent.kl_weight
        return lambda step: weight
    f32 = np.float32
    total = f32(cfg.sde.kl_anneal_portion_vada * num_total_iter)
    const = f32(cfg.sde.kl_const_portion_vada * num_total_iter)
    mn, mx = cfg.sde.kl_const_coeff_vada, cfg.sde.kl_max_coeff_vada

    def weight(step: int) -> float:
        # JAX's weak typing: each Python scalar rounds to float32 where it
        # meets the float32 step, (max - min) after its double subtraction
        coeff = f32(mn) + f32(mx - mn) * (f32(step) - const) / total
        return float(np.clip(coeff, f32(mn), f32(mx)))

    return weight


class TrainStep:
    """One optimizer step per call (`__call__`): `objective`'s loss and its
    gradients in full float32 (`no_tf32`), Adam, the EMA, then
    `after_update`. `optimizer.count` is the JAX TrainState's `step`."""

    def __init__(self, params, lr_schedule: Callable[[int], float], opt,
                 clip_norm: float, ema_decay: float):
        self.params = list(params)
        self.optimizer = Optimizer(
            self.params, lr_schedule, opt.beta1, opt.beta2, opt.weight_decay,
            clip_norm)
        self.ema = EMA(self.params, ema_decay) if ema_decay > 0 else None

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        """-> (the loss to differentiate, the metrics `__call__` returns)."""
        raise NotImplementedError

    def after_update(self) -> None:
        """Runs after Adam and the EMA."""

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, **draws):
        """x on the model's device -> metrics (0-d tensors, not
        synchronised); `draws` are the objective's given draws."""
        self.optimizer.zero_grad()
        with no_tf32():
            loss, metrics = self.objective(x, generator, **draws)
            loss.backward()
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update()
        self.after_update()
        return {k: (v.detach() if torch.is_tensor(v) else v)
                for k, v in metrics.items()}


class VAETrainStep(TrainStep):
    """The stage-1 step: the VAE's ELBO with the KL anneal, Adam with
    trainer.opt's clip and the EMA at trainer.opt.ema_decay under
    ddpm.ema."""

    def __init__(self, vae: VAE, lr_schedule: Callable[[int], float],
                 num_total_iter: int = 0):
        cfg = as_view(vae.cfg)
        check_vae_supported(cfg)
        opt = cfg.trainer.opt
        super().__init__(vae.parameters(), lr_schedule, opt, opt.grad_clip,
                         float(opt.ema_decay) if cfg.ddpm.ema else 0.0)
        self.vae = vae
        self.kl_weight = kl_weight_schedule(cfg, num_total_iter)

    def loss(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None, **draws):
        """The step's loss output (`VAE.get_loss`) at the current KL weight,
        in train mode, the dropout masks drawn from `generator`."""
        self.vae.train()
        set_dropout_generator(self.vae, generator)
        return self.vae.get_loss(
            x, kl_weight=self.kl_weight(self.optimizer.count),
            generator=generator, **draws)

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        """x (B, N, input_dim); `draws` are `VAE.get_loss`'s `rho` and
        `noisy_input`. The metrics are the loss and the print/ and msg/
        keys (print/kl_weight a float)."""
        out = self.loss(x, generator, **draws)
        return out["loss"], {k: v for k, v in out.items()
                             if k == "loss" or k.startswith(("print/",
                                                             "msg/"))}


def default_vae_lr_schedule(cfg, steps_per_epoch: int = 1):
    """The schedule the stage-1 trainer builds: warmup over
    trainer.opt.vae_lr_warmup_epochs epochs, then cosine from
    trainer.opt.lr to lr_min over trainer.epochs
    (lion_tpu/trainers/hvae_trainer.py:31-40)."""
    cfg = as_view(cfg)
    opt = cfg.trainer.opt
    return warmup_cosine_schedule(
        opt.lr, opt.lr_min, int(opt.vae_lr_warmup_epochs * steps_per_epoch),
        cfg.trainer.epochs, opt.vae_lr_warmup_epochs, steps_per_epoch)


def make_vae_train_step(vae: VAE,
                        lr_schedule: Optional[Callable[[int], float]] = None,
                        num_total_iter: int = 0,
                        device="cuda") -> VAETrainStep:
    """The stage-1 training step of `vae`, moved to `device` (the card
    unless the caller asks for "cpu"; without CUDA the default raises).
    `lr_schedule` defaults to `default_vae_lr_schedule(vae.cfg)`;
    `num_total_iter` is the run's length in steps, over which the KL weight
    anneals when trainer.anneal_kl is set."""
    vae.to(resolve_device(device))
    if lr_schedule is None:
        lr_schedule = default_vae_lr_schedule(vae.cfg)
    return VAETrainStep(vae, lr_schedule, num_total_iter)


def prior_loss(lion: LION, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               rho: Optional[Sequence[torch.Tensor]] = None,
               timestep: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None):
    """The two-prior loss of x (B, N, 3): returns (loss, metrics) with
    metrics {"loss", "train/p_loss_0", "train/p_loss_1"} (0-d tensors).

    Draws from `generator` (on x's device) in this order: the encoder's two
    posterior noises unless `rho = (rho_global, rho_local)` is given, t
    unless `timestep` (B,) is given, the two diffusion noises unless
    `noise = (noise_global, noise_local)` is given, then the dropout masks
    of the global prior and of the local prior. Puts the VAE in eval mode
    and the priors in train mode."""
    check_supported(lion.cfg)
    b, dev = x.shape[0], x.device
    lion.vae.eval()
    lion.global_prior.train()
    lion.local_prior.train()
    set_dropout_generator(lion.global_prior, generator)
    set_dropout_generator(lion.local_prior, generator)
    with torch.no_grad():
        eps, _, _ = lion.vae.encode(x, generator, rho)
    eps = eps.float()
    eps_global, eps_local = eps[:, :lion.style_dim], eps[:, lion.style_dim:]
    diffusion = lion.diffusion
    t, var_t, m_t = diffusion.iw_quantities(
        b, generator, None if timestep is None else timestep.to(dev))
    if noise is None:
        noise = tuple(torch.randn(e.shape, generator=generator, device=dev)
                      for e in (eps_global, eps_local))
    metrics: Dict[str, torch.Tensor] = {}
    losses = []
    for i, (prior, eps_i, noise_i) in enumerate(
            ((lion.global_prior, eps_global, noise[0]),
             (lion.local_prior, eps_local, noise[1]))):
        eps_t = diffusion.sample_q(eps_i, noise_i, var_t, m_t)
        if i == 0:
            pred = prior(eps_t, t.float())
        else:   # global2style is the identity
            pred = prior(eps_t, t.float(), condition_input=eps_global)
        pred = pred.float()
        if lion.mixed_prediction:
            pred = get_mixed_prediction(
                pred, prior.mixing_logit,
                diffusion.get_mixing_component(eps_t, t))
        p_loss = torch.mean(torch.square(pred - noise_i))
        metrics[f"train/p_loss_{i}"] = p_loss
        losses.append(p_loss)
    loss = losses[0] + losses[1]
    metrics["loss"] = loss
    return loss, metrics


class PriorTrainStep(TrainStep):
    """The two-prior step: `prior_loss`, Adam with sde.grad_clip_max_norm,
    the EMA at sde.ema_decay and the mixing-logit clamp of the JAX step."""

    def __init__(self, lion: LION, lr_schedule: Callable[[int], float]):
        cfg = as_view(lion.cfg)
        check_supported(cfg)
        super().__init__(
            list(lion.global_prior.parameters())
            + list(lion.local_prior.parameters()), lr_schedule,
            cfg.trainer.opt, cfg.sde.grad_clip_max_norm,
            float(cfg.sde.ema_decay))
        self.lion = lion
        self.bound_mlogit = (bool(cfg.sde.bound_mlogit)
                             and lion.mixed_prediction)
        self.bound_mlogit_value = float(cfg.sde.bound_mlogit_value)

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        """x (B, N, 3); `draws` are `prior_loss`'s given draws."""
        return prior_loss(self.lion, x, generator, **draws)

    def after_update(self) -> None:
        if self.bound_mlogit:
            with torch.no_grad():
                for prior in (self.lion.global_prior, self.lion.local_prior):
                    prior.mixing_logit.clamp_(max=self.bound_mlogit_value)


def default_lr_schedule(cfg, steps_per_epoch: int = 1):
    """The schedule train_2prior.py builds: warmup over sde.warmup_epochs
    epochs, then cosine from sde.learning_rate_dae to learning_rate_min_dae
    (lion_tpu/trainers/train_2prior.py:122-128)."""
    cfg = as_view(cfg)
    return warmup_cosine_schedule(
        cfg.sde.learning_rate_dae, cfg.sde.learning_rate_min_dae,
        steps_per_epoch * cfg.sde.warmup_epochs, cfg.sde.epochs,
        cfg.sde.warmup_epochs, steps_per_epoch)


def make_prior_train_step(lion: LION,
                          lr_schedule: Optional[Callable[[int], float]] = None,
                          device="cuda") -> PriorTrainStep:
    """The two-prior training step of `lion`, moved to `device` (the card
    unless the caller asks for "cpu"; without CUDA the default raises).
    `lr_schedule` defaults to `default_lr_schedule(lion.cfg)`."""
    lion.to(resolve_device(device))
    if lr_schedule is None:
        lr_schedule = default_lr_schedule(lion.cfg)
    return PriorTrainStep(lion, lr_schedule)
