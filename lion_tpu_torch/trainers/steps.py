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
  2. one t per item, shared by both priors: t ~ U{1..T} of the discrete
     DDPM, or under sde.ode_sample the continuous VPSDE's importance-sampled
     t in (0, 1] (`sde.iw_sample_p`, `sde.time_eps`) with its objective
     weight;
  3. each latent is noised with `sample_q`;
  4. the global and the local prior run in train mode (dropout, the PVConv
     modular flow on K10, gradients through K2/K11, K3, K5 and K6);
  5. mixed prediction where `sde.mixed_prediction` is set;
  6. per latent, loss = mean((pred - noise)^2) (`pvd_mse_loss = 1`, the
     released objective), or the weighted objective mean_b(sum(w_t (pred -
     noise)^2)) (`pvd_mse_loss = 0`; w_t the p2 weight or 1 for the DDPM)
     plus the regularizers: sde.weight_decay_norm_dae times the kernels'
     spectral norms (4 power iterations, `utils.spectral_norm`) and the
     norm scales' max, sde.regularize_mlogit's penalty on the summed
     sigmoid of both mixing logits, and under the continuous diffusion the
     Jacobian (jac_reg_samples Hutchinson probes v of the probability-flow
     drift alpha (v sqrt(var_t) - J^T v), J^T v a second backward
     (create_graph), masked on steps off jac_reg_freq) and kinetic terms;
     these enter once per latent, so twice in the total, as in the JAX
     package;
  7. the two latents' losses summed; backward; Adam on the warmup-cosine
     schedule; the EMA; the `bound_mlogit` clamp of both mixing logits.

Every random number (the encoder's posterior noise, t, the two diffusion
noises, every dropout mask, the Jacobian probes) comes from the
`torch.Generator` the caller passes; the step hands it to the Dropout
modules of both priors (`set_dropout_generator`). All but the masks may be
given instead, so a test can feed both packages the same numbers. Float32
matmuls and cuDNN convolutions run in full float32 inside the step
(`no_tf32`), whatever the global flags say.

Under `tpu.bf16` (which the trainers set for `sde.autocast_train`) the
U-Nets compute in bf16 (K10, K2-K6 in bf16, the norms in float32), as the
JAX package's bf16 steps do; the parameters, Adam's moments, the EMA, the
losses and the diffusion targets stay float32.

Conditioning: under data.cond_on_cat the steps take `class_label` (B,):
the VAE step's decoder reads it, and the two-prior step conditions the
local prior on concat([eps_global, cls_emb]) with the frozen VAE's class
embedding, computed without gradient (lion_tpu/trainers/steps.py:47-53,
154-206). Under clipforge.enable the two-prior step takes `clip_feat`
(B, clipforge.feat_dim), which both priors read.

Data parallel (one process a device, parallel/dist.py): inside a process
group the step broadcasts rank 0's parameters and EMA once when it is
built, averages the gradients over the ranks after the backward (one flat
all_reduce, before the clip and Adam, which then see the global batch's
gradient) and returns the metrics averaged over the ranks; each rank's
step is otherwise the one-process step on its own rows. Losses that sum
over the batch (`*_sum`) are averaged like the rest, as the reference's
per-GPU scripts average them. Without a group nothing of this runs.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config.view import as_view
from ..diffusion.continuous import make_diffusion
from ..diffusion.discrete import get_mixed_prediction
from ..diffusion.schedules import make_beta_schedule
from ..models.lion import LION, resolve_device
from ..models.vae import VAE
from ..nn.common import set_dropout_generator
from ..ops._cuda import no_tf32
from ..parallel.dist import (average_gradients, average_values,
                             broadcast_params, initialized)
from ..utils.spans import span
from ..utils.spectral_norm import (init_sn_state, norm_scale_loss,
                                   spectral_norm_loss)
from .optim import EMA, Optimizer, warmup_cosine_schedule


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
        self.distributed = initialized()
        if self.distributed:
            broadcast_params(self.params)
        self.optimizer = Optimizer(
            self.params, lr_schedule, opt.beta1, opt.beta2, opt.weight_decay,
            clip_norm)
        self.ema = EMA(self.params, ema_decay) if ema_decay > 0 else None
        if self.distributed and self.ema is not None:
            broadcast_params(self.ema.shadow)

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        """-> (the loss to differentiate, the metrics `__call__` returns)."""
        raise NotImplementedError

    def after_update(self) -> None:
        """Runs after Adam and the EMA."""

    def precision(self):
        """The precision of the loss and its gradients: full float32."""
        return no_tf32()

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, **draws):
        """x on the model's device -> metrics (0-d tensors, not
        synchronised; the ranks' means inside a process group); `draws`
        are the objective's given draws and conditioning inputs. The step
        is the span `train.step`, its phases `train.forward`,
        `train.backward` and `train.update` (`utils.spans`)."""
        with span("train.step"):
            self.optimizer.zero_grad()
            with self.precision():
                with span("train.forward"):
                    loss, metrics = self.objective(x, generator, **draws)
                with span("train.backward"):
                    loss.backward()
            with span("train.update"):
                for p in self.params:
                    # a parameter the loss does not reach (the Fourier
                    # embedding's w) gets a zero gradient, as the JAX
                    # package's optimizer sees it
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if self.distributed:
                    average_gradients(self.params)
                    keys = sorted(k for k, v in metrics.items()
                                  if torch.is_tensor(v))
                    metrics.update(zip(keys, average_values(
                        [metrics[k] for k in keys])))
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
        """x (B, N, input_dim); `draws` are `VAE.get_loss`'s `rho`,
        `noisy_input` and `class_label`. The metrics are the loss and the
        print/ and msg/ keys (print/kl_weight a float)."""
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


def _add(a, b):
    return b if a is None else a + b


class Objective:
    """The stage-2 objective's settings of a config (lion_tpu/trainers/
    steps.py:86-125): the continuous diffusion under sde.ode_sample, the
    weighted objective (`pvd_mse_loss = 0`) and its regularizers."""

    def __init__(self, cfg, mixed: bool):
        cfg = as_view(cfg)
        sde = cfg.sde
        self.sde = sde
        self.is_cont = bool(sde.ode_sample)
        self.continuous = make_diffusion(sde) if self.is_cont else None
        self.weighted = not bool(cfg.latent_pts.pvd_mse_loss)
        self.mixed = mixed
        self.wdn = float(sde.weight_decay_norm_dae)
        self.use_sn = self.wdn > 0.0 and self.weighted
        self.reg_mlogit = float(sde.regularize_mlogit)
        self.reg_mlogit_margin = float(sde.regularize_mlogit_margin)
        self.use_reg_mlogit = self.reg_mlogit > 0.0 and self.weighted \
            and mixed
        self.jac_coeff = float(sde.jac_reg_coeff) if self.weighted else 0.0
        self.kin_coeff = float(sde.kin_reg_coeff) if self.weighted else 0.0
        self.jac_freq = max(int(sde.jac_reg_freq), 1)
        self.jac_samples = max(int(sde.jac_reg_samples), 1)
        self.drop_weights = bool(sde.jac_kin_reg_drop_weights)
        if (self.jac_coeff > 0.0 or self.kin_coeff > 0.0) and not (
                self.is_cont and mixed):
            raise ValueError("the Jacobian and kinetic regularizers need "
                             "continuous diffusion (sde.ode_sample) and "
                             "mixed prediction")

    def quantities(self, discrete, b: int, generator, device,
                   timestep=None, iw_rho=None):
        """The diffusion of the step and its (t, var_t, m_t, obj_w): the
        continuous VPSDE's importance sampling from `iw_rho` (B,) uniforms
        or the generator, or the DDPM's t from `timestep` or the generator
        with its loss weight."""
        if self.is_cont:
            t, var_t, m_t, obj_w, _, _ = self.continuous.iw_quantities(
                b, float(self.sde.time_eps), self.sde.iw_sample_p, generator,
                iw_rho, device)
            return self.continuous, t, var_t, m_t, obj_w
        t, var_t, m_t = discrete.iw_quantities(
            b, generator, None if timestep is None else timestep.to(device))
        return discrete, t, var_t, m_t, discrete.loss_weight(t)

    def mixing_component(self, diffusion, eps_t, var_t, t):
        if self.is_cont:
            return diffusion.mixing_component(eps_t, var_t, t)
        return diffusion.get_mixing_component(eps_t, t)

    def norm_terms(self, named_params, mixing_logits, sn_state, metrics):
        """The spectral-norm, norm-scale and mixing-logit terms (None when
        all are off); the new power-iteration vectors go into sn_state."""
        reg = None
        if self.use_sn:
            sn, new_state = spectral_norm_loss(named_params, sn_state)
            reg = (sn + norm_scale_loss(named_params)) * self.wdn
            metrics["train/dae_norm_loss"] = sn
            sn_state.update(new_state)
        if self.use_reg_mlogit:
            ml_sum = sum(torch.sum(torch.sigmoid(ml)) for ml in mixing_logits)
            reg = _add(reg, self.reg_mlogit * torch.square(
                ml_sum - self.reg_mlogit_margin))
        return reg


def prior_loss(lion: LION, x: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               rho: Optional[Sequence[torch.Tensor]] = None,
               timestep: Optional[torch.Tensor] = None,
               noise: Optional[Sequence[torch.Tensor]] = None,
               iw_rho: Optional[torch.Tensor] = None,
               jac_probes=None, sn_state=None, step: int = 0,
               class_label=None, clip_feat=None):
    """The two-prior loss of x (B, N, 3): returns (loss, metrics) with
    metrics {"loss", "train/p_loss_0", "train/p_loss_1"} and, when they are
    on, "train/dae_norm_loss", "train/jac_reg_{0,1}" and
    "train/kin_reg_{0,1}" (0-d tensors).

    Draws from `generator` (on x's device) in this order: the encoder's two
    posterior noises unless `rho = (rho_global, rho_local)` is given, t
    unless `timestep` (B,) (DDPM) or `iw_rho` (B,) (the continuous
    diffusion's uniforms) is given, the two diffusion noises unless
    `noise = (noise_global, noise_local)` is given, then per prior its
    dropout masks and its jac_reg_samples Jacobian probes unless
    `jac_probes = (probes_global, probes_local)` (each a sequence of
    tensors of the latent's shape) is given. `sn_state` holds the
    spectral-norm power-iteration vectors (required when
    sde.weight_decay_norm_dae > 0 under the weighted objective), updated
    in place; `step` is the optimizer step that jac_reg_freq reads.
    `class_label` (B,) under data.cond_on_cat and `clip_feat` (B,
    clipforge.feat_dim) under clipforge.enable condition the priors. Puts
    the VAE in eval mode and the priors in train mode."""
    obj = Objective(lion.cfg, lion.mixed_prediction)
    b, dev = x.shape[0], x.device
    lion.vae.eval()
    lion.global_prior.train()
    lion.local_prior.train()
    set_dropout_generator(lion.global_prior, generator)
    set_dropout_generator(lion.local_prior, generator)
    with span("prior.encode"), torch.no_grad():
        cls_emb, clip_feat = lion.condition_inputs(b, class_label,
                                                   clip_feat)
        eps, _, _ = lion.vae.encode(x, generator, rho)
    eps = eps.float()
    eps_global, eps_local = eps[:, :lion.style_dim], eps[:, lion.style_dim:]
    # global2style is the identity; the class embedding joins the local
    # prior's condition (train_2prior.py:243-245, 297-301)
    condition = eps_global if cls_emb is None else \
        torch.cat([eps_global, cls_emb], dim=1)
    diffusion, t, var_t, m_t, obj_w = obj.quantities(
        lion.diffusion, b, generator, dev, timestep, iw_rho)
    if noise is None:
        noise = tuple(torch.randn(e.shape, generator=generator, device=dev)
                      for e in (eps_global, eps_local))
    metrics: Dict[str, torch.Tensor] = {}
    priors = (lion.global_prior, lion.local_prior)
    reg_p = None
    if obj.weighted:
        named = [(f"{name}.{k}", p) for name in ("global_prior",
                                                 "local_prior")
                 for k, p in getattr(lion, name).named_parameters()]
        reg_p = obj.norm_terms(named, [p.mixing_logit for p in priors]
                               if obj.mixed else [], sn_state, metrics)
    losses = []
    for i, (prior, eps_i, noise_i) in enumerate(
            zip(priors, (eps_global, eps_local), noise)):
        eps_t = diffusion.sample_q(eps_i, noise_i, var_t, m_t)
        if obj.jac_coeff > 0.0:
            eps_t.requires_grad_(True)
        if i == 0:
            pred_raw = prior(eps_t, t.float(), clip_feat=clip_feat)
        else:
            pred_raw = prior(eps_t, t.float(), condition_input=condition,
                             clip_feat=clip_feat)
        pred_raw = pred_raw.float()
        pred = pred_raw
        if obj.mixed:
            pred = get_mixed_prediction(
                pred, prior.mixing_logit,
                obj.mixing_component(diffusion, eps_t, var_t, t))
        if not obj.weighted:
            p_loss = torch.mean(torch.square(pred - noise_i))
        else:
            l2 = torch.square(pred - noise_i)
            p_obj = torch.sum(obj_w * l2.reshape(b, -1), dim=1)
            reg = _regularizers(obj, diffusion, prior, eps_t, pred_raw,
                                t, var_t, generator, step, metrics, i,
                                None if jac_probes is None
                                else jac_probes[i], reg_p)
            p_loss = torch.mean(p_obj)
            if reg is not None:
                p_loss = p_loss + reg
        metrics[f"train/p_loss_{i}"] = p_loss
        losses.append(p_loss)
    loss = losses[0] + losses[1]
    metrics["loss"] = loss
    return loss, metrics


def _regularizers(obj: Objective, diffusion, prior, eps_t, pred_raw, t,
                  var_t, generator, step, metrics, i, probes, reg):
    """`reg` (the norm terms, or None) plus the Jacobian and kinetic terms
    of latent i:
    the probability-flow drift alpha (v sqrt(var_t) - J^T v), times
    f(t) / sqrt(var_t) unless sde.jac_kin_reg_drop_weights, with alpha the
    detached sigmoid of the prior's mixing logit; the Jacobian term is its
    mean squared norm over Gaussian probes v with J^T v by a backward of the
    prior's output that keeps its graph (so the loss differentiates it
    again), times 0 on steps that jac_reg_freq skips; the kinetic term puts
    v = eps_t and the prediction for J^T v (lion_tpu/trainers/steps.py:
    225-269)."""
    if obj.jac_coeff <= 0.0 and obj.kin_coeff <= 0.0:
        return reg
    b = eps_t.shape[0]
    alpha = torch.sigmoid(prior.mixing_logit.detach())
    sqrt_var = torch.sqrt(var_t)
    f_t = diffusion.f(t).reshape(b, 1)

    def drift(v, jv):
        d = alpha * (v * sqrt_var - jv)
        if not obj.drop_weights:
            d = f_t / sqrt_var * d
        return d

    if obj.jac_coeff > 0.0:
        sq_norms = []
        for s in range(obj.jac_samples):
            probe = probes[s].to(eps_t.device) if probes is not None else \
                torch.randn(eps_t.shape, generator=generator,
                            device=eps_t.device)
            jvp = torch.autograd.grad(pred_raw, eps_t, probe,
                                      create_graph=True, retain_graph=True)[0]
            d = drift(probe, jvp.float())
            sq_norms.append(torch.sum(d.reshape(b, -1) ** 2, dim=1,
                                      keepdim=True))
        jac_loss = torch.mean(torch.cat(sq_norms, dim=1))
        gate = float(step % obj.jac_freq == 0) if obj.jac_freq > 1 else 1.0
        reg = _add(reg, obj.jac_coeff * gate * jac_loss)
        metrics[f"train/jac_reg_{i}"] = jac_loss
    if obj.kin_coeff > 0.0:
        kin_loss = torch.mean(torch.sum(
            drift(eps_t.detach(), pred_raw).reshape(b, -1) ** 2, dim=1))
        reg = _add(reg, obj.kin_coeff * kin_loss)
        metrics[f"train/kin_reg_{i}"] = kin_loss
    return reg


class PriorTrainStep(TrainStep):
    """The two-prior step: `prior_loss`, Adam with sde.grad_clip_max_norm,
    the EMA at sde.ema_decay and the mixing-logit clamp of the JAX step.
    Under the weighted objective with sde.weight_decay_norm_dae > 0 it
    carries the spectral norm's power-iteration vectors (`sn_state`, drawn
    by `init_sn_state` at build, not checkpointed, as in the JAX
    package)."""

    def __init__(self, lion: LION, lr_schedule: Callable[[int], float]):
        cfg = as_view(lion.cfg)
        super().__init__(
            list(lion.global_prior.parameters())
            + list(lion.local_prior.parameters()), lr_schedule,
            cfg.trainer.opt, cfg.sde.grad_clip_max_norm,
            float(cfg.sde.ema_decay))
        self.lion = lion
        self.bound_mlogit = (bool(cfg.sde.bound_mlogit)
                             and lion.mixed_prediction)
        self.bound_mlogit_value = float(cfg.sde.bound_mlogit_value)
        self.sn_state = init_sn_state(
            (f"{name}.{k}", p) for name in ("global_prior", "local_prior")
            for k, p in getattr(lion, name).named_parameters()) \
            if Objective(cfg, lion.mixed_prediction).use_sn else None

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        """x (B, N, 3); `draws` are `prior_loss`'s given draws."""
        return prior_loss(self.lion, x, generator, sn_state=self.sn_state,
                          step=self.optimizer.count, **draws)

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


class DiT3DTrainStep(TrainStep):
    """DiT-3D's step (PVD's objective, `train_generation.py`, which
    DiT-3D's `train.py` keeps): t ~ U{0..T-1}, eps ~ N(0, I) over the
    points, each label dropped to the null row with probability
    dit3d.class_dropout_prob; x_t = sqrt(ab_t) x + sqrt(1 - ab_t) eps with
    the coefficients computed in float64 and rounded to float32, as PVD's
    tables are; loss = mean((model(x_t, t, y) - eps)^2); Adam with
    trainer.opt's betas, clip and weight decay, the EMA under ddpm.ema.

    The draws come from the caller's generator (t, then eps, then the
    dropout's uniforms), or are given: `t` (B,) int64, `noise` (B, N, 3),
    `drop` (B,) bool; `class_label` (B,) defaults to zeros. Float32
    throughout, TF32 only under dit3d.tf32 (`DiT3D.precision`)."""

    def __init__(self, model, lr_schedule: Callable[[int], float]):
        cfg = as_view(model.cfg)
        opt = cfg.trainer.opt
        super().__init__(model.parameters(), lr_schedule, opt,
                         opt.grad_clip,
                         float(opt.ema_decay) if cfg.ddpm.ema else 0.0)
        self.model = model
        self.drop_prob = float(cfg.dit3d.class_dropout_prob)
        ab = np.cumprod(1.0 - make_beta_schedule(
            cfg.ddpm.sched_mode, cfg.ddpm.beta_1, cfg.ddpm.beta_T,
            int(cfg.ddpm.num_steps)).astype(np.float64))
        dev = next(model.parameters()).device
        self.sqrt_ab = torch.from_numpy(np.sqrt(ab)).float().to(dev)
        self.sqrt_1m_ab = torch.from_numpy(np.sqrt(1.0 - ab)).float().to(dev)

    def precision(self):
        return self.model.precision()

    def draws(self, x: torch.Tensor, generator=None, t=None, noise=None,
              drop=None):
        """(t, noise, drop): the given ones, the rest drawn from
        `generator` (on its device) in that order."""
        b, gdev = x.shape[0], (generator.device if generator is not None
                               else x.device)
        if t is None:
            t = torch.randint(0, self.sqrt_ab.shape[0], (b,),
                              generator=generator, device=gdev)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=gdev)
        if drop is None:
            drop = torch.rand(b, generator=generator,
                              device=gdev) < self.drop_prob
        return t.to(x.device), noise.to(x.device), drop.to(x.device)

    def loss(self, x: torch.Tensor, generator=None, t=None, noise=None,
             drop=None, class_label=None) -> torch.Tensor:
        """The step's loss in train mode, on the given or drawn draws."""
        self.model.train()
        t, noise, drop = self.draws(x, generator, t, noise, drop)
        x_t = self.sqrt_ab[t][:, None, None] * x \
            + self.sqrt_1m_ab[t][:, None, None] * noise
        eps = self.model(x_t, t, class_label, drop)
        return ((eps - noise) ** 2).mean()

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, **draws):
        loss = self.loss(x, generator, **draws)
        return loss, {"loss": loss}


def dit3d_lr_schedule(cfg, steps_per_epoch: int = 1):
    """trainer.opt.lr times trainer.opt.step_decay per finished epoch
    (PVD's ExponentialLR, stepped once an epoch)."""
    opt = as_view(cfg).trainer.opt
    lr, decay = float(opt.lr), float(opt.step_decay)
    return lambda step: lr * decay ** (step // max(steps_per_epoch, 1))
