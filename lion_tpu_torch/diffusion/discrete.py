"""Discrete DDPM / DDIM (port of lion_tpu/diffusion/discrete.py: the
constants, the training quantities `iw_quantities`, `iw_quantities_t`,
`loss_weight`, `sample_q` and `get_mixing_component`, the ancestral sampler
`_ancestral_step`, `run_denoising_diffusion` and `_denoise_ts`, and the
DDIM sampler `ddim_tau_schedule` and `run_ddim`).

The JAX package scans the chain inside one program; here it is a Python
loop over the steps (a CUDA graph of the step is later work).

Conventions kept (utils/diffusion_pvd.py):
  * models see timesteps t+1 in [1, T];
  * fixed 'beta' log-scales: std = exp(0.5 * log(betas[t]));
  * the t == 0 step emits the posterior mean with the 1/sqrt(alpha_bar[0])
    convention and no noise;
  * DDIM: kappa is eta, with uniform or quad skips of the T steps;
  * mixed prediction: eps = (1-sigmoid(logit)) * sqrt(1-ab_t) * x
    + sigmoid(logit) * pred.

The schedule is built in float64 and stored in float32; every per-step
coefficient is evaluated in float32 on the host, as the JAX package
evaluates it, and enters the tensor math as a Python float that holds that
float32 value exactly.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.spans import span
from .schedules import make_beta_schedule


def get_mixed_prediction(pred, mixing_logit, mixing_component):
    coeff = torch.sigmoid(mixing_logit)
    return (1.0 - coeff) * mixing_component + coeff * pred


def randn(shape, generator, device):
    """Standard normal noise from `generator` (its own device), moved to
    `device`; the default generator when None."""
    if generator is None:
        return torch.randn(shape, device=device)
    noise = torch.randn(shape, generator=generator, device=generator.device)
    return noise.to(device)


class DiffusionDiscretized:
    """Schedule constants (from cfg.ddpm) and the ancestral sampler."""

    def __init__(self, cfg):
        ddpm = cfg.ddpm
        self.num_steps = int(ddpm.num_steps)
        betas = make_beta_schedule(ddpm.sched_mode, ddpm.beta_1, ddpm.beta_T,
                                   self.num_steps)
        alphas = 1.0 - betas
        alpha_bars = np.cumprod(alphas)
        self.betas = betas.astype(np.float32)
        self.alphas = alphas.astype(np.float32)
        self.alpha_bars = alpha_bars.astype(np.float32)
        self.snr = (1.0 / (1.0 - alpha_bars) - 1.0).astype(np.float32)
        self.use_p2_weight = bool(ddpm.use_p2_weight)
        self.p2_k, self.p2_gamma = float(ddpm.p2_k), float(ddpm.p2_gamma)

    # ---------------------------------------------------------- training
    def _alpha_bars_at(self, timestep: torch.Tensor) -> torch.Tensor:
        table = torch.from_numpy(self.alpha_bars).to(timestep.device)
        return table[timestep.long() - 1]

    def iw_quantities(self, batch_size: int, generator: torch.Generator,
                      timestep: Optional[torch.Tensor] = None):
        """t ~ U{1..T} from `generator` (on its device), or the given
        timesteps; returns (timestep (B,) int32, var_t (B, 1), m_t (B, 1))
        (lion_tpu/diffusion/discrete.py:64-85 without its loss weight,
        which `loss_weight` gives)."""
        if timestep is None:
            rho = torch.rand(batch_size, generator=generator,
                             device=generator.device) * self.num_steps
            # rand < 1, but rand * T may round up to T in float32
            timestep = torch.clamp(rho.to(torch.int32) + 1,
                                   max=self.num_steps)
        return self.iw_quantities_t(timestep)

    def iw_quantities_t(self, timestep: torch.Tensor):
        """(timestep, var_t, m_t) for given timesteps in [1, T]."""
        alpha_bars = self._alpha_bars_at(timestep)
        return (timestep.to(torch.int32), (1.0 - alpha_bars)[:, None],
                torch.sqrt(alpha_bars)[:, None])

    def loss_weight(self, timestep: torch.Tensor) -> torch.Tensor:
        """The weighted objective's per-item weight (B, 1) at timesteps in
        [1, T]: the p2 weight 1 / (p2_k + snr_t)^p2_gamma in float32 under
        ddpm.use_p2_weight, else ones (lion_tpu/diffusion/discrete.py:
        76-85)."""
        if not self.use_p2_weight:
            return torch.ones((timestep.shape[0], 1), device=timestep.device)
        snr = torch.from_numpy(self.snr).to(timestep.device)
        table = 1.0 / (self.p2_k + snr) ** self.p2_gamma
        return table[timestep.long() - 1][:, None]

    @staticmethod
    def sample_q(x_init, noise, var_t, m_t):
        """A sample of q(x_t | x_0): m_t * x_0 + sqrt(var_t) * noise."""
        return m_t * x_init + torch.sqrt(var_t) * noise

    def get_mixing_component(self, x_noisy, timestep):
        """sqrt(1 - alpha_bar_t) * x_t, broadcast over x's trailing dims."""
        shape = (x_noisy.shape[0],) + (1,) * (x_noisy.ndim - 1)
        return torch.sqrt(1.0 - self._alpha_bars_at(timestep)).reshape(
            shape) * x_noisy

    def _coefficients(self, t: int):
        """float32 per-step scalars of the step at index t."""
        one, half = np.float32(1.0), np.float32(0.5)
        ab0, ab = self.alpha_bars[0], self.alpha_bars[t]
        return dict(
            sqrt_1m_ab0=float(np.sqrt(one - ab0)), sqrt_ab0=float(np.sqrt(ab0)),
            beta=float(self.betas[t]), sqrt_1m_ab=float(np.sqrt(one - ab)),
            sqrt_alpha=float(np.sqrt(self.alphas[t])),
            std=float(np.exp(half * np.log(self.betas[t]))))

    def _ancestral_step(self, model_fn: Callable, x, t: int, noise,
                        mixing_logit=None):
        """One p(x_{t-1} | x_t) step from x at step index t."""
        k = self._coefficients(t)
        with span("chain.prior"):
            timestep = torch.full((x.shape[0],), t + 1, dtype=torch.float32,
                                  device=x.device)
            pred = model_fn(x, timestep)
        if mixing_logit is not None:
            mix = k["sqrt_1m_ab"] * x
            pred = get_mixed_prediction(
                pred, mixing_logit.reshape(x.shape[1:]), mix)
        if t == 0:
            return (x - k["sqrt_1m_ab0"] * pred) / k["sqrt_ab0"]
        mean = (x - k["beta"] * pred / k["sqrt_1m_ab"]) / k["sqrt_alpha"]
        return mean + k["std"] * noise

    def _denoise_ts(self, model_fn: Callable, x, ts: Sequence[int],
                    generator: Optional[torch.Generator] = None,
                    mixing_logit=None, given_noise=None):
        """Run the reverse chain over the step indices `ts` (descending).
        `given_noise` (T, B, ...) replaces the Gaussian draw of step t by
        given_noise[t], reshaped to x's shape. Each step is a span
        `chain.update` (the draw and the update) around its `chain.prior`."""
        for t in ts:
            t = int(t)
            with span("chain.update"):
                if given_noise is not None:
                    noise = given_noise[t].reshape(x.shape).to(x.device)
                elif t > 0:
                    noise = randn(x.shape, generator, x.device)
                else:
                    noise = None
                x = self._ancestral_step(model_fn, x, t, noise,
                                         mixing_logit)
        return x

    def run_denoising_diffusion(self, model_fn: Callable, num_samples: int,
                                shape, generator=None, device=None,
                                mixing_logit=None, x_noisy=None,
                                given_noise=None):
        """The full T-step ancestral sampler. model_fn(x, timestep) -> eps.
        Returns x_0 of shape (num_samples, *shape)."""
        x_shape = (num_samples,) + tuple(shape)
        if x_noisy is None:
            x_noisy = randn(x_shape, generator, device)
        x = x_noisy.reshape(x_shape)
        if device is not None:
            x = x.to(device)
        return self._denoise_ts(model_fn, x, range(self.num_steps - 1, -1, -1),
                                generator, mixing_logit, given_noise)

    # ---------------------------------------------------------- DDIM
    def ddim_tau_schedule(self, ddim_step: int, skip_type: str = "uniform"):
        """The step indices DDIM visits, descending, ending at 0."""
        s = ddim_step
        if skip_type == "uniform":
            c = (self.num_steps - 1.0) / (s - 1.0)
            taus = [int(np.floor(i * c)) for i in range(s)]
        elif skip_type == "quad":
            seq = np.linspace(0, np.sqrt(self.num_steps * 0.8), s) ** 2
            taus = [int(x) for x in seq]
        else:
            raise NotImplementedError(skip_type)
        return sorted(taus, reverse=True)

    def ddim_constants(self, ddim_step: int, skip_type: str = "uniform",
                       kappa: float = 1.0):
        """(taus, alpha_next, sigma): per DDIM step its index t, the
        alpha_bar of the next index (1 at the end) and the noise scale
        kappa * sqrt((1 - a_next) / (1 - ab_t) * (1 - ab_t / a_next)) (0
        at the end), in float32 as the JAX package stores them."""
        taus = self.ddim_tau_schedule(ddim_step, skip_type)
        ab = self.alpha_bars
        alpha_next, sigma = [], []
        for i, t in enumerate(taus):
            if i == len(taus) - 1:
                assert t == 0
                alpha_next.append(1.0)
                sigma.append(0.0)
            else:
                a_next = ab[taus[i + 1]]
                alpha_next.append(a_next)
                sigma.append(kappa * np.sqrt(
                    (1 - a_next) / (1 - ab[t]) * (1 - ab[t] / a_next)))
        return (taus, np.asarray(alpha_next, np.float32),
                np.asarray(sigma, np.float32))

    def run_ddim(self, model_fn: Callable, num_samples: int, shape,
                 ddim_step: int, skip_type: str = "uniform",
                 kappa: float = 1.0, generator=None, device=None,
                 mixing_logit=None, x_noisy=None):
        """The DDIM sampler over the tau schedule: x <- sqrt(a_next / a_t)
        * x + c * eps + sigma * noise, c = sqrt(max(1 - a_next - sigma^2,
        0)) - sqrt(1 - a_t) * sqrt(a_next / a_t). The initial x and every
        noise draw come from `generator`; a step whose sigma is 0 draws
        none. Each step is a span `chain.prior` (the prior call), then a
        span `chain.update` (the rest of the step). Returns x_0 of shape
        (num_samples, *shape)."""
        x_shape = (num_samples,) + tuple(shape)
        if x_noisy is None:
            x_noisy = randn(x_shape, generator, device)
        x = x_noisy.reshape(x_shape)
        if device is not None:
            x = x.to(device)
        taus, alpha_next, sigma = self.ddim_constants(ddim_step, skip_type,
                                                      kappa)
        one = np.float32(1.0)
        for t, a_next, sig in zip(taus, alpha_next, sigma):
            a_tau = self.alpha_bars[t]
            with span("chain.prior"):
                timestep = torch.full((num_samples,), t + 1,
                                      dtype=torch.float32, device=x.device)
                pred = model_fn(x, timestep)
            with span("chain.update"):
                if mixing_logit is not None:
                    mix = float(np.sqrt(one - a_tau)) * x
                    pred = get_mixed_prediction(
                        pred, mixing_logit.reshape(x_shape[1:]), mix)
                scale = np.sqrt(a_next / a_tau)
                c = np.sqrt(np.maximum(one - a_next - sig * sig,
                                       np.float32(0))) \
                    - np.sqrt(one - a_tau) * scale
                x = float(scale) * x + float(c) * pred
                if sig != 0:
                    x = x + float(sig) * randn(x_shape, generator, x.device)
        return x
