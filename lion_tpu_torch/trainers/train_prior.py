"""The stage-2 single-prior trainer (port of lion_tpu/trainers/
train_prior.py).

One `GlobalPrior` (the 'se_drop' ResNet of sde.num_channels_dae wide
blocks; under clipforge.enable the 'se_clip' blocks over the batch's CLIP
features, lion_tpu/trainers/train_prior.py:39-58, 93-116) over the
composed latent eps = [z_global, z_local] of the frozen
VAE: style_dim + N (latent_dim + input_dim) values a shape, 8320 at the
flagship. Its step: the frozen encode without gradients, t ~ U{1..T}
(or the continuous VPSDE's importance-sampled t under sde.ode_sample) and
`sample_q`, the prior in train mode with dropout, mixed prediction where
sde.mixed_prediction is set, the MSE against the noise (pvd_mse, the
released objective) or the weighted objective with the spectral-norm,
norm-scale and mixing-logit terms added once (`pvd_mse_loss = 0`; the JAX
package's single prior takes no Jacobian or kinetic term), then Adam and
the EMA. Sampling runs the ancestral chain over eps, splits it into the
two latents and decodes, under sde.ode_sample too, as in the JAX package
(under clipforge.enable with the test split's features). Class
conditioning is a two-prior feature (train_2prior.py:241-245): under
data.cond_on_cat the trainer refuses to build, as the JAX one does.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

from ..ckpt.io import (adam_state_from_tree, adam_state_tree,
                       load_tensors_tree, module_arrays, tensors_tree)
from ..config.view import as_view
from ..diffusion.discrete import DiffusionDiscretized, get_mixed_prediction
from ..models.priors import GlobalPrior
from ..models.vae import VAE
from ..nn.common import init_weights, set_dropout_generator
from ..parallel.dist import fold_seed
from ..utils.spectral_norm import init_sn_state
from .steps import Objective, TrainStep, default_lr_schedule
from .train_2prior import Trainer as TwoPriorTrainer


class SinglePriorTrainStep(TrainStep):
    """One optimizer step of the single prior per call, with Adam at
    sde.grad_clip_max_norm and the EMA at sde.ema_decay
    (lion_tpu/trainers/train_prior.py:71-153); `sn_state` as
    `PriorTrainStep`'s."""

    def __init__(self, vae: VAE, dae: GlobalPrior,
                 diffusion: DiffusionDiscretized,
                 lr_schedule: Callable[[int], float]):
        cfg = as_view(vae.cfg)
        super().__init__(dae.parameters(), lr_schedule, cfg.trainer.opt,
                         cfg.sde.grad_clip_max_norm,
                         float(cfg.sde.ema_decay))
        self.vae, self.dae, self.diffusion = vae, dae, diffusion
        self.mixed_prediction = bool(cfg.sde.mixed_prediction)
        self.obj = Objective(cfg, self.mixed_prediction)
        self.sn_state = init_sn_state(
            (f"dae.{k}", p) for k, p in dae.named_parameters()) \
            if self.obj.use_sn else None

    def objective(self, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  rho: Optional[Sequence[torch.Tensor]] = None,
                  timestep: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None,
                  iw_rho: Optional[torch.Tensor] = None, clip_feat=None):
        """The loss of x (B, N, 3) -> (loss, {"loss"} and, with the
        spectral norm on, "train/dae_norm_loss"). Draws from `generator`
        in this order unless given: the encoder's two posterior noises
        (`rho`), t (`timestep` (B,), or the continuous diffusion's uniforms
        `iw_rho` (B,)), the diffusion noise (`noise`, eps's shape), then
        the prior's dropout masks. `clip_feat` (B, clipforge.feat_dim)
        conditions the 'se_clip' prior."""
        b, dev = x.shape[0], x.device
        obj = self.obj
        self.vae.eval()
        self.dae.train()
        set_dropout_generator(self.dae, generator)
        with torch.no_grad():
            eps, _, _ = self.vae.encode(x, generator, rho)
        eps = eps.float()
        diffusion, t, var_t, m_t, obj_w = obj.quantities(
            self.diffusion, b, generator, dev, timestep, iw_rho)
        if noise is None:
            noise = torch.randn(eps.shape, generator=generator, device=dev)
        eps_t = diffusion.sample_q(eps, noise, var_t, m_t)
        pred = self.dae(eps_t, t.float(), clip_feat=clip_feat).float()
        if self.mixed_prediction:
            pred = get_mixed_prediction(
                pred, self.dae.mixing_logit,
                obj.mixing_component(diffusion, eps_t, var_t, t))
        metrics = {}
        if not obj.weighted:
            loss = torch.mean(torch.square(pred - noise))
        else:
            l2 = torch.square(pred - noise)
            loss = torch.mean(torch.sum(obj_w * l2.reshape(b, -1), dim=1))
            reg = obj.norm_terms(
                [(f"dae.{k}", p) for k, p in self.dae.named_parameters()],
                [self.dae.mixing_logit] if self.mixed_prediction else [],
                self.sn_state, metrics)
            if reg is not None:
                loss = loss + reg
        metrics["loss"] = loss
        return loss, metrics


class Trainer(TwoPriorTrainer):
    """The single-prior variant: its own prior, step, sampling and
    checkpoint trees (dae, vae, opt, ema); the data, the VAE hand-over,
    the loop and `eval_sample` are the two-prior trainer's."""

    @classmethod
    def check_config(cls, cfg) -> None:
        if cfg.data.cond_on_cat:
            raise NotImplementedError(
                "data.cond_on_cat requires trainer.type=trainers.train_2prior"
                " (lion_tpu/trainers/train_prior.py:36-37)")

    def build_prior(self):
        cfg = self.cfg
        n = cfg.data.tr_max_sample_points
        self.eps_dim = cfg.latent_pts.style_dim + n * (
            cfg.shapelatent.latent_dim + cfg.ddpm.input_dim)
        clip_on = bool(cfg.clipforge.enable)
        with self.device:
            self.dae = GlobalPrior(
                num_input_channels=self.eps_dim,
                nf=cfg.sde.num_channels_dae,
                num_blocks=cfg.sde.num_cell_per_scale_dae,
                embedding_dim=cfg.sde.embedding_dim,
                embedding_type=cfg.sde.embedding_type,
                embedding_scale=cfg.sde.embedding_scale,
                dropout=cfg.sde.dropout,
                block_type="se_clip" if clip_on else "se_drop",
                mixed_prediction=bool(cfg.sde.mixed_prediction),
                mixing_logit_init=cfg.sde.mixing_logit_init,
                clip_forge_enable=clip_on,
                clip_feat_dim=cfg.clipforge.feat_dim)
        init_weights(self.dae,
                     torch.Generator().manual_seed(cfg.trainer.seed + 2))
        self.diffusion = DiffusionDiscretized(as_view(cfg))
        self.step_fn = SinglePriorTrainStep(
            self.vae, self.dae, self.diffusion,
            default_lr_schedule(cfg, self._steps_per_epoch()))
        self.param_names = [f"dae.{n}" for n, _ in
                            self.dae.named_parameters()]
        self.generator = torch.Generator(device=self.device).manual_seed(
            fold_seed(cfg.trainer.seed, 13))
        self.build_clip_encoder()

    @torch.no_grad()
    def sample(self, num_samples: int = 16, generator=None,
               use_ema: bool = True, ddim_step: int = 0,
               given_noise=None, clip_feat=None,
               local: bool = False) -> torch.Tensor:
        """The ancestral chain over the composed eps from the (EMA) prior,
        split into [z_global, z_local] and decoded -> points (B, N, 3)
        (lion_tpu/trainers/train_prior.py:155-175, which takes no mixing
        logit in the chain and ancestral steps whatever `ddim_step`).
        `given_noise` (init (B, eps_dim), steps (T, B, eps_dim)) replaces
        every draw of the chain. Under clipforge.enable `clip_feat`
        defaults to the test split's features; `local` is accepted for the
        trainers' interface (each rank samples its own rows)."""
        if clip_feat is None:
            clip_feat = self._test_clip_feat(num_samples)
        if clip_feat is not None:
            clip_feat = torch.as_tensor(clip_feat, dtype=torch.float32,
                                        device=self.device)
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        init, steps = given_noise if given_noise is not None else (None,
                                                                   None)
        ema = self.step_fn.ema if use_ema else None
        self.dae.eval()
        self.vae.eval()
        with ema.swapped() if ema is not None else contextlib.nullcontext():
            eps = self.diffusion.run_denoising_diffusion(
                lambda x, t: self.dae(x, t, clip_feat=clip_feat),
                num_samples, (self.eps_dim,), gen, self.device,
                x_noisy=init, given_noise=steps)
        style_dim = self.cfg.latent_pts.style_dim
        return self.vae.sample(num_samples,
                               [eps[:, :style_dim], eps[:, style_dim:]])

    def state_trees(self):
        step = self.step_fn
        mu, nu = step.optimizer.moments()
        trees = {"dae": module_arrays(self.dae),
                 "vae": module_arrays(self.vae),
                 "opt": adam_state_tree(step.optimizer.count, mu, nu,
                                        self.param_names)}
        if step.ema is not None:
            names = [n for n, _ in self.dae.named_parameters()]
            trees["ema"] = tensors_tree(names, step.ema.shadow)
        return trees

    def load_state_trees(self, trees, metadata):
        step = self.step_fn
        names = [n for n, _ in self.dae.named_parameters()]
        load_tensors_tree(names, step.params, trees["dae"])
        if "opt" in trees:
            step.optimizer.load_state(*adam_state_from_tree(
                trees["opt"], self.param_names))
        if "ema" in trees and step.ema is not None:
            load_tensors_tree(names, step.ema.shadow, trees["ema"])
        if "vae" in trees:
            vae_names, vae_tensors = zip(*self.vae.named_parameters())
            load_tensors_tree(vae_names, vae_tensors, trees["vae"])
        step.optimizer.count = int(metadata.get("step", 0))

    def export_torch(self, path: str):
        raise NotImplementedError(
            "the released .pt schema holds the two-prior pair ('0.' global, "
            "'1.' local); the single prior has no place in it")
