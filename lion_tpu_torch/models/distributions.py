"""Reparameterized Normal (port of lion_tpu/models/distributions.py).

Sampling draws its standard normal from a `torch.Generator` that the caller
passes, or takes it given (`rho`), so a test can feed both packages the
same numbers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class Normal:
    def __init__(self, mu: torch.Tensor, log_sigma: torch.Tensor):
        self.mu = mu
        self.log_sigma = log_sigma
        self.sigma = torch.exp(log_sigma)

    def sample(self, generator: Optional[torch.Generator] = None,
               rho: Optional[torch.Tensor] = None):
        """(rho * sigma + mu, rho), rho ~ N(0, 1) from `generator` (on mu's
        device) unless given."""
        if rho is None:
            rho = torch.randn(self.mu.shape, generator=generator,
                              device=self.mu.device, dtype=self.mu.dtype)
        return rho * self.sigma + self.mu, rho

    def log_p(self, samples: torch.Tensor) -> torch.Tensor:
        normalized = (samples - self.mu) / self.sigma
        return -0.5 * normalized * normalized - 0.5 * _LOG_2PI \
            - self.log_sigma

    def kl_to_standard(self) -> torch.Tensor:
        """Pointwise KL(q || N(0, 1)) = 0.5 sigma^2 + 0.5 mu^2 - log_sigma
        - 0.5 (vae_adain.py:250-252)."""
        return (0.5 * torch.exp(self.log_sigma) ** 2 + 0.5 * self.mu ** 2
                - self.log_sigma - 0.5)
