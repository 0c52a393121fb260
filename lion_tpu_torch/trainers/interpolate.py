"""Latent interpolation (port of lion_tpu/trainers/interpolate.py;
reference trainers/interpolate_latent.py and encode_interp_interp.py).

Noise-space interpolation between two endpoint samples: the prior noises of
the first and the last row are blended ('interpolate': the sqrt-weighted,
variance-preserving blend; 'linear_interpolate'; 'freeze': every row
row 0), both priors sample from them (the ancestral chain, or with
`use_ode` the probability-flow ODE of the continuous VPSDE), and the VAE
decodes. Posterior interpolation encodes two real shapes, diffuses their
latents forward to a time t, blends the noisy latents and runs the
reverse chain from t; its PF-ODE form (`interpolate_posterior_ode`) maps
both endpoints' latents to noise space with the forward ODE, blends there
and integrates the reverse ODE.

Like lion_tpu's, these chains and ODEs apply no mixed prediction. Every
draw comes from the caller's generator, or is given: the initial noises
(`noise`), the per-step noises (`given_noise`, (T, B, D) indexed by the
step) and the encoder's posterior normals (`rho`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.view import as_view
from ..diffusion.continuous import make_diffusion
from ..diffusion.discrete import randn
from .train_2prior import Trainer as TwoPriorTrainer


def _blend(noise: torch.Tensor, weights) -> torch.Tensor:
    """Rows 1..K-2 become w0(p) * row 0 + w1(p) * row K-1, p = i / K."""
    k = noise.shape[0]
    p = torch.arange(k, dtype=torch.float32, device=noise.device)[:, None] / k
    w0, w1 = weights(p)
    mid = w1 * noise[-1][None] + w0 * noise[0][None]
    inner = (torch.arange(k, device=noise.device) > 0) & \
        (torch.arange(k, device=noise.device) < k - 1)
    return torch.where(inner[:, None], mid, noise)


def linear_interpolate_noise(noise: torch.Tensor) -> torch.Tensor:
    """noise (K, D): rows 1..K-2 linearly blend rows 0 and K-1
    (interpolate_latent.py:24-32)."""
    return _blend(noise, lambda p: (1 - p, p))


def interpolate_noise(noise: torch.Tensor) -> torch.Tensor:
    """The variance-preserving sqrt-weighted blend
    (interpolate_latent.py:34-42)."""
    return _blend(noise, lambda p: (torch.sqrt(1 - p), torch.sqrt(p)))


def freeze_noise(noise: torch.Tensor) -> torch.Tensor:
    """Every row is row 0 (the 'freeze' local mode)."""
    return noise[0][None].expand(noise.shape).clone()


MODES = {
    "interpolate": interpolate_noise,
    "linear_interpolate": linear_interpolate_noise,
    "freeze": freeze_noise,
    "none": lambda n: n,
}


@torch.no_grad()
def generate_interpolation(lion, num_samples: int,
                           generator: Optional[torch.Generator] = None,
                           mode_global: str = "interpolate",
                           mode_local: str = "freeze",
                           use_ode: bool = False, noise=None,
                           given_noise=None, ode_eps: float = 1e-5,
                           ode_solver_tol: float = 1e-5) -> dict:
    """num_samples shapes whose prior noises interpolate between the first
    and the last row (interpolate_latent.py generate_samples:120-173), from
    `lion`'s current parameters. `noise` = (noise_global (B, style),
    noise_local (B, N*C)) are the rows before the modes blend them;
    `given_noise` = (steps_global, steps_local) the per-step draws of the
    two chains. With `use_ode` both priors integrate the PF-ODE (dopri5 at
    ode_solver_tol, to ode_eps) from the blended noises instead. Returns
    points, z_global, z_local and, under the ODE, the function evaluations
    (`nfe`)."""
    lion.eval()
    dev = lion.device
    noise_g, noise_l = noise if noise is not None else (
        randn((num_samples, lion.style_dim), generator, dev),
        randn((num_samples, lion.local_dim), generator, dev))
    steps_g, steps_l = given_noise if given_noise is not None else (None,
                                                                     None)
    noise_g = MODES[mode_global](noise_g.to(dev))
    noise_l = MODES[mode_local](noise_l.to(dev))
    if use_ode:
        sde = make_diffusion(as_view(lion.cfg).sde)
        z_global, nfe_g = sde.sample_model_ode(
            lion.global_prior, num_samples, (lion.style_dim,), ode_eps,
            ode_solver_tol, noise=noise_g)
        z_local, nfe_l = sde.sample_model_ode(
            lambda x, t: lion.local_prior(x, t, condition_input=z_global),
            num_samples, (lion.local_dim,), ode_eps, ode_solver_tol,
            noise=noise_l)
        points = lion.vae.sample(num_samples, [z_global, z_local])
        return {"points": points, "z_global": z_global, "z_local": z_local,
                "nfe": nfe_g + nfe_l}
    diffusion = lion.diffusion
    z_global = diffusion.run_denoising_diffusion(
        lion.global_prior, num_samples, (lion.style_dim,), generator, dev,
        x_noisy=noise_g, given_noise=steps_g)
    z_local = diffusion.run_denoising_diffusion(
        lambda x, t: lion.local_prior(x, t, condition_input=z_global),
        num_samples, (lion.local_dim,), generator, dev, x_noisy=noise_l,
        given_noise=steps_l)
    points = lion.vae.sample(num_samples, [z_global, z_local])
    return {"points": points, "z_global": z_global, "z_local": z_local}


def _run_from_t(diffusion, model_fn, x_noisy: torch.Tensor, time_start: int,
                generator: Optional[torch.Generator] = None,
                given_noise=None) -> torch.Tensor:
    """The reverse chain from step `time_start` to 0
    (diffusion_pvd.py:503-563 run_denoising_diffusion_from_t): the
    ancestral steps at indices time_start-1 .. 0."""
    return diffusion._denoise_ts(model_fn, x_noisy,
                                 range(time_start - 1, -1, -1), generator,
                                 given_noise=given_noise)


@torch.no_grad()
def interpolate_posterior(lion, x_a: torch.Tensor, x_b: torch.Tensor,
                          num_steps: int,
                          generator: Optional[torch.Generator] = None,
                          diffuse_t: int = 200, rho=None, noise=None,
                          given_noise=None) -> dict:
    """Posterior interpolation (encode_interp_interp.py): encode x_a and
    x_b (N, 3), diffuse both latents forward to step diffuse_t (at most
    T), blend them over `num_steps` rows with sqrt weights, run both
    chains back from there (the local one conditioned on the global
    result) and decode. `rho` (the encoder's two posterior normals),
    `noise` (the forward-diffusion noise, (2, D)) and `given_noise`
    (steps_global, steps_local) may be given."""
    diffusion = lion.diffusion
    diffuse_t = min(diffuse_t, diffusion.num_steps)
    lion.eval()
    dev = lion.device
    x = torch.stack([x_a, x_b]).to(dev)
    eps, _, _ = lion.vae.encode(x, generator, rho)
    t = torch.full((2,), diffuse_t, dtype=torch.int32, device=dev)
    _, var_t, m_t = diffusion.iw_quantities_t(t)
    if noise is None:
        noise = randn(eps.shape, generator, dev)
    eps_t = diffusion.sample_q(eps, noise.to(dev), var_t, m_t)
    p = torch.from_numpy(np.linspace(0.0, 1.0, num_steps,
                                     dtype=np.float32))[:, None].to(dev)
    eps_interp = torch.sqrt(1 - p) * eps_t[0][None] + \
        torch.sqrt(p) * eps_t[1][None]
    steps_g, steps_l = given_noise if given_noise is not None else (None,
                                                                     None)
    style_dim = lion.style_dim
    z_g = _run_from_t(diffusion, lion.global_prior,
                      eps_interp[:, :style_dim], diffuse_t, generator,
                      steps_g)
    z_l = _run_from_t(
        diffusion,
        lambda xx, tt: lion.local_prior(xx, tt, condition_input=z_g),
        eps_interp[:, style_dim:], diffuse_t, generator, steps_l)
    points = lion.vae.sample(num_steps, [z_g, z_l])
    return {"points": points, "z_global": z_g, "z_local": z_l}


def _endpoint_rows(ends: torch.Tensor, num_steps: int) -> torch.Tensor:
    """The two noise-space endpoints (2, D) as the first and last of
    num_steps rows, the rows between blended by `interpolate_noise`."""
    mid = torch.zeros((num_steps - 2, ends.shape[1]), device=ends.device)
    return interpolate_noise(torch.cat([ends[:1], mid, ends[1:]]))


@torch.no_grad()
def interpolate_posterior_ode(lion, x_a: torch.Tensor, x_b: torch.Tensor,
                              num_steps: int,
                              generator: Optional[torch.Generator] = None,
                              ode_eps: float = 1e-5,
                              ode_solver_tol: float = 1e-5,
                              rho=None) -> dict:
    """Deterministic posterior interpolation through the probability-flow
    ODE (encode_interp_interp.py:240-295): encode x_a and x_b (N, 3) with
    the VAE (`rho`, the encoder's two posterior normals, may be given),
    map each level's latent to noise space with the forward ODE
    (`compute_ode_encode`; the local prior conditioned on the two endpoint
    global latents), blend num_steps rows there with sqrt weights,
    integrate the reverse ODE (the local prior conditioned on the global
    result) and decode. Returns points, z_global, z_local and the function
    evaluations of the four integrations (`nfe`: enc_g, enc_l, dec_g,
    dec_l)."""
    lion.eval()
    dev = lion.device
    sde = make_diffusion(as_view(lion.cfg).sde)
    x = torch.stack([x_a, x_b]).to(dev)
    eps, _, _ = lion.vae.encode(x, generator, rho)
    style_dim = lion.style_dim
    eps_g, eps_l = eps[:, :style_dim], eps[:, style_dim:]
    eps_T_g, nfe_eg = sde.compute_ode_encode(lion.global_prior, eps_g,
                                             ode_eps, ode_solver_tol)
    z_global, nfe_g = sde.sample_model_ode(
        lion.global_prior, num_steps, (style_dim,), ode_eps, ode_solver_tol,
        noise=_endpoint_rows(eps_T_g, num_steps))
    eps_T_l, nfe_el = sde.compute_ode_encode(
        lambda xx, tt: lion.local_prior(xx, tt, condition_input=eps_g),
        eps_l, ode_eps, ode_solver_tol)
    z_local, nfe_l = sde.sample_model_ode(
        lambda xx, tt: lion.local_prior(xx, tt, condition_input=z_global),
        num_steps, (eps_l.shape[1],), ode_eps, ode_solver_tol,
        noise=_endpoint_rows(eps_T_l, num_steps))
    points = lion.vae.sample(num_steps, [z_global, z_local])
    return {"points": points, "z_global": z_global, "z_local": z_local,
            "nfe": {"enc_g": nfe_eg, "enc_l": nfe_el, "dec_g": nfe_g,
                    "dec_l": nfe_l}}


# Eval-only trainers under the reference's trainer.type strings
# (trainers.interpolate_latent / trainers.encode_interp_interp)
def _check_unconditioned(cls, cfg) -> None:
    """The interpolations sample without class labels or CLIP features: in
    lion_tpu they give the local prior z_global alone and the global prior
    no features, so a class- or CLIP-conditioned config fails there."""
    if cfg.data.cond_on_cat or cfg.clipforge.enable:
        raise NotImplementedError(
            f"{cls.__name__}: the interpolations take no class label or "
            "CLIP feature (data.cond_on_cat, clipforge.enable)")


class InterpolateLatentTrainer(TwoPriorTrainer):
    """reference trainers/interpolate_latent.py: shapes whose prior noises
    interpolate between the first and the last row, from the EMA
    priors."""

    check_config = classmethod(_check_unconditioned)

    def sample(self, num_samples: int = 16, generator=None,
               use_ema: bool = True, ddim_step: int = 0,
               given_noise=None, local: bool = False) -> torch.Tensor:
        """`ddim_step` and `local` are accepted for the trainers'
        interface (each rank interpolates its own rows); the chains
        are ancestral, or under sde.ode_sample the PF-ODE to sde.ode_eps at
        `generate_interpolation`'s fixed tolerance, as in lion_tpu. The
        draws come from `generator`, by default one seeded 0."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        with self.as_lion(use_ema) as lion:
            out = generate_interpolation(
                lion, num_samples, gen,
                mode_global=self.cfg.tpu.interp_mode_global,
                mode_local=self.cfg.tpu.interp_mode_local,
                use_ode=bool(self.cfg.sde.ode_sample),
                given_noise=given_noise,
                ode_eps=float(self.cfg.sde.ode_eps))
        return out["points"]


class EncodeInterpTrainer(TwoPriorTrainer):
    """reference trainers/encode_interp_interp.py: encode two real shapes,
    interpolate in the diffused latent space, reverse, decode."""

    check_config = classmethod(_check_unconditioned)

    def endpoints(self) -> torch.Tensor:
        """The two endpoint clouds (2, N, 3): the first two of the test
        split; seeded random clouds only when there is no test split."""
        if self.test_loader is None or len(self.test_loader) == 0:
            gen = torch.Generator().manual_seed(1)
            return torch.randn((2, self.cfg.data.tr_max_sample_points, 3),
                               generator=gen)
        batch = next(iter(self.test_loader))
        pts = np.asarray(batch["tr_points"], np.float32)[:2]
        if len(pts) < 2:
            raise ValueError("EncodeInterpTrainer: the test split's first "
                             f"batch holds {len(pts)} cloud(s), not 2")
        return torch.from_numpy(pts)

    def sample(self, num_samples: int = 16, generator=None,
               use_ema: bool = True, ddim_step: int = 0,
               diffuse_t: int = 200, local: bool = False) -> torch.Tensor:
        """`num_samples` rows between the two endpoints, diffused to step
        `diffuse_t`, or under sde.ode_sample encoded and decoded by the
        PF-ODE at `interpolate_posterior_ode`'s fixed ode_eps and
        tolerance, as in lion_tpu; `ddim_step` and `local` are accepted
        for the trainers' interface. The draws come from `generator`, by
        default one seeded 0."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        x = self.endpoints().to(self.device)
        with self.as_lion(use_ema) as lion:
            if self.cfg.sde.ode_sample:
                out = interpolate_posterior_ode(lion, x[0], x[1],
                                                num_samples, gen)
            else:
                out = interpolate_posterior(lion, x[0], x[1], num_samples,
                                            gen, diffuse_t=diffuse_t)
        return out["points"]
