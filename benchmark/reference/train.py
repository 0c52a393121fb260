"""The two training objectives of the reference and their optimizer:

- stage 1, the VAE's ELBO: the reconstruction loss (`ddpm.loss_type`,
  here the released `l1_sum`) plus the KL of both posteriors to N(0, 1),
  weighted per group and by the annealed KL weight (vae_adain.py);
- stage 2, the two priors' noise-prediction loss on the frozen VAE's
  latents: per latent mean((eps_theta(x_t, t) - noise)^2), summed
  (train_2prior.py, `pvd_mse_loss = 1`);
- Adam (torch.optim.Adam's update, written out) and the EMA of the
  parameters, after each update: ema <- ema decay + p (1 - decay).

Random numbers come from the caller's generator in the order the released
code draws them: stage 1 the style encoder's dropout masks, the style
posterior's normal, the encoder's masks, the points' normal, the decoder's
masks; stage 2 the two posterior normals, t, the two diffusion noises, the
global prior's masks, the local prior's masks.
"""
from __future__ import annotations

import numpy as np
import torch

from .diffusion import Schedule
from .model import set_generator


def kl_weight(cfg, step: int, total_iter: int) -> float:
    """The KL weight at an optimizer step: annealed linearly from
    sde.kl_const_coeff_vada to kl_max_coeff_vada over the
    kl_anneal_portion_vada share of `total_iter` after its
    kl_const_portion_vada share (float32), else shapelatent.kl_weight."""
    sde = cfg["sde"]
    if not (cfg["trainer"]["anneal_kl"] and total_iter > 0):
        return float(cfg["shapelatent"]["kl_weight"])
    f = np.float32
    total = f(sde["kl_anneal_portion_vada"] * total_iter)
    const = f(sde["kl_const_portion_vada"] * total_iter)
    lo, hi = sde["kl_const_coeff_vada"], sde["kl_max_coeff_vada"]
    w = f(lo) + f(hi - lo) * (f(step) - const) / total
    return float(np.clip(w, f(lo), f(hi)))


def _kl(mu, log_sigma):
    return 0.5 * torch.exp(log_sigma) ** 2 + 0.5 * mu ** 2 - log_sigma - 0.5


class _Given(torch.autograd.Function):
    """Forward: `given`'s values; backward: the gradient to `own`, as if
    `own` had gone on."""

    @staticmethod
    def forward(ctx, own, given):
        return given.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _use(own: dict, given) -> dict:
    """`own` with each value of `given` of as many values and rows put in
    its place (reshaped to it), the gradient still flowing to `own`."""
    use = dict(own)
    for k, v in (given or {}).items():
        o = own.get(k)
        if o is not None and v.numel() == o.numel() \
                and v.shape[0] == o.shape[0]:
            use[k] = _Given.apply(o, v.reshape(o.shape).to(o.dtype))
    return use


def vae_loss(cfg, vae, x, generator, weight: float, given=None):
    """The stage-1 loss of x (B, N, 3), in train mode -> (loss, the
    decoder's inputs it computed: {"local": z_local, "style": z_global}).
    `given` holds such inputs to decode in place of its own (the encoder's
    gradient flows as through its own), the draws made as without them."""
    if cfg["ddpm"]["loss_type"] != "l1_sum":
        raise NotImplementedError(cfg["ddpm"]["loss_type"])
    lp = cfg["latent_pts"]
    vae.train()
    set_generator(vae, generator)
    b, d = x.shape[0], vae.input_dim
    z_g, mu_g, ls_g, z_l, mu_l, ls_l = vae.encode(x, generator)
    own = {"local": z_l, "style": z_g}
    use = _use(own, given)
    rec = torch.sum(torch.abs(vae.decode(use["style"], use["local"]) - x))
    kl_glb = _kl(mu_g, ls_g).reshape(b, -1).sum(-1)
    kl3 = _kl(mu_l, ls_l).reshape(b, -1, vae.latent_dim + d)
    kl_pt = kl3[..., :d].sum(dim=(1, 2))
    kl_feat = kl3[..., d:].sum(dim=(1, 2))
    kl = weight * (kl_glb * lp["weight_kl_glb"] + kl_pt * lp["weight_kl_pt"]
                   + kl_feat * lp["weight_kl_feat"])
    return kl.mean() + rec * cfg["weight_recont"], own


def prior_loss(cfg, lion, x, generator, clip_feat=None, given=None):
    """The two-prior loss of x (B, N, 3) on the frozen VAE -> (loss, the
    priors' inputs it computed: {"global": x_t, "local": x_t, "condition":
    the global latent}). `given` holds such inputs to feed the priors in
    place of its own (each where its shape is the same), the draws made as
    without them."""
    if not cfg["latent_pts"]["pvd_mse_loss"]:
        raise NotImplementedError("the weighted objective")
    lion.vae.eval()
    for p in (lion.global_prior, lion.local_prior):
        p.train()
        set_generator(p, generator)
    with torch.no_grad():
        z_g, _, _, z_l, _, _ = lion.vae.encode(x, generator)
    t, var_t, m_t = Schedule(cfg).noising(x.shape[0], generator,
                                          x.device)
    noise = [torch.randn(z.shape, generator=generator, device=x.device)
             for z in (z_g, z_l)]
    own = {"global": m_t * z_g + torch.sqrt(var_t) * noise[0],
           "local": m_t * z_l + torch.sqrt(var_t) * noise[1],
           "condition": z_g}
    use = _use(own, given)
    pred_g = lion.global_prior(use["global"], t.float(), clip_feat=clip_feat)
    pred_l = lion.local_prior(use["local"], t.float(), use["condition"],
                              clip_feat=clip_feat)
    loss = torch.mean(torch.square(pred_g - noise[0])) \
        + torch.mean(torch.square(pred_l - noise[1]))
    return loss, own


class Adam:
    """m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2) g^2;
    p <- p - lr / (1 - b1^k) m / (sqrt(v) / sqrt(1 - b2^k) + eps)."""

    def __init__(self, params, lr, beta1, beta2, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.k = 0

    @torch.no_grad()
    def step(self, grads):
        self.k += 1
        bc1, bc2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + self.eps))
