"""Beta schedules (reference: utils/diffusion.py:28-65 `make_beta_schedule`).

Computed in float64 numpy at build time (static shapes), stored fp32.
"""
from __future__ import annotations

import numpy as np


def make_beta_schedule(mode: str, start: float, end: float,
                       n_timestep: int) -> np.ndarray:
    if mode == "cust":  # airplane: warmup over first 10% then constant end
        betas = end * np.ones(n_timestep, dtype=np.float64)
        warmup_time = int(n_timestep * 0.1)
        betas[:warmup_time] = np.linspace(start, end, warmup_time,
                                          dtype=np.float64)
    elif mode == "quad":
        betas = np.linspace(start ** 0.5, end ** 0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif mode == "linear":
        betas = np.linspace(start, end, n_timestep, dtype=np.float64)
    elif mode == "warmup10":
        betas = _warmup_beta(start, end, n_timestep, 0.1)
    elif mode == "warmup50":
        betas = _warmup_beta(start, end, n_timestep, 0.5)
    elif mode == "const":
        betas = end * np.ones(n_timestep, dtype=np.float64)
    elif mode == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    else:
        raise NotImplementedError(mode)
    return betas


def _warmup_beta(start, end, n_timestep, frac):
    betas = end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * frac)
    betas[:warmup_time] = np.linspace(start, end, warmup_time,
                                      dtype=np.float64)
    return betas
