"""The discrete diffusion of the reference: the linear beta schedule, the
DDIM tau schedule and update (Song et al. 2021, eta = `ddim_kappa`), and
the training noising of the two-prior objective.

The schedule is built in float64 and kept in float32, as the released code
stores it; DDIM's per-step coefficients are evaluated in float64 from those
float32 values.
"""
from __future__ import annotations

import numpy as np
import torch


class Schedule:
    def __init__(self, cfg):
        ddpm = cfg["ddpm"]
        if ddpm["sched_mode"] != "linear":
            raise NotImplementedError(ddpm["sched_mode"])
        self.steps = int(ddpm["num_steps"])
        betas = np.linspace(ddpm["beta_1"], ddpm["beta_T"], self.steps,
                            dtype=np.float64)
        self.alpha_bars = np.cumprod(1.0 - betas).astype(np.float32)

    def ddim(self, ddim_step: int, skip_type: str = "uniform",
             kappa: float = 1.0):
        """[(t, scale, c, sigma)] per DDIM step, t descending to 0:
        x <- scale x + c eps + sigma noise."""
        if skip_type != "uniform":
            raise NotImplementedError(skip_type)
        step = (self.steps - 1.0) / (ddim_step - 1.0)
        taus = sorted((int(np.floor(i * step)) for i in range(ddim_step)),
                      reverse=True)
        ab = self.alpha_bars.astype(np.float64)
        out = []
        for i, t in enumerate(taus):
            a_t = ab[t]
            a_next = 1.0 if i == len(taus) - 1 else ab[taus[i + 1]]
            sigma = 0.0 if i == len(taus) - 1 else kappa * np.sqrt(
                (1 - a_next) / (1 - a_t) * (1 - a_t / a_next))
            scale = np.sqrt(a_next / a_t)
            c = np.sqrt(max(1 - a_next - sigma * sigma, 0.0)) \
                - np.sqrt(1 - a_t) * scale
            out.append((t, float(scale), float(c), float(sigma)))
        return out

    def noising(self, batch: int, generator, device):
        """t ~ U{1..T} (B,) from `generator` and (var_t, m_t) (B, 1)."""
        rho = torch.rand(batch, generator=generator, device=device) \
            * self.steps
        t = torch.clamp(rho.to(torch.int32) + 1, max=self.steps)
        ab = torch.from_numpy(self.alpha_bars).to(t.device)[t.long() - 1]
        return t, (1.0 - ab)[:, None], torch.sqrt(ab)[:, None]
