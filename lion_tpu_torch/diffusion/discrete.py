"""Discrete DDPM ancestral sampling (port of lion_tpu/diffusion/discrete.py:
the constants, `_ancestral_step`, `run_denoising_diffusion` and
`_denoise_ts`).

The JAX package scans the chain inside one program; here it is a Python
loop over the steps (a CUDA graph of the step is later work).

Conventions kept (utils/diffusion_pvd.py):
  * models see timesteps t+1 in [1, T];
  * fixed 'beta' log-scales: std = exp(0.5 * log(betas[t]));
  * the t == 0 step emits the posterior mean with the 1/sqrt(alpha_bar[0])
    convention and no noise;
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
        given_noise[t], reshaped to x's shape."""
        for t in ts:
            t = int(t)
            if given_noise is not None:
                noise = given_noise[t].reshape(x.shape).to(x.device)
            elif t > 0:
                noise = randn(x.shape, generator, x.device)
            else:
                noise = None
            x = self._ancestral_step(model_fn, x, t, noise, mixing_logit)
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
