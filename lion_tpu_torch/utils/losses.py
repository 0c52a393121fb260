"""Reconstruction losses and the KL schedule of the VAE (port of
lion_tpu/utils/losses.py).

The reductions follow the JAX package exactly: the `*_sum` types sum over
the whole batch to a scalar; `cd_sum`, `chamfer`, `emd` and `chamfer_emd`
give one value per item. The EMD types use the differentiable
`ops.emd.emd_approx` (the match detached, as the JAX package stops its
gradient), the chamfer types `ops.chamfer`; all of it plain PyTorch, as
XLA computes it in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.chamfer import chamfer_dist, chamfer_l1
from ..ops.emd import emd_approx


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str,
            point_dim: int, batch_size: int,
            loss_weight_emd: float = 0.02) -> torch.Tensor:
    """The reconstruction loss of `pred` against `target` (B, N, D)."""
    del point_dim   # the nearest neighbours are taken over xyz
    b = batch_size
    if loss_type == "l1_sum":
        return torch.sum(torch.abs(pred - target))
    if loss_type == "mse_sum":
        return torch.sum(torch.square(pred - target))
    if loss_type == "mse":
        return torch.mean(torch.square(pred - target))
    if loss_type == "cd1_sum":
        dl, dr = chamfer_l1(pred, target)
        return torch.sum(dl) + torch.sum(dr)
    if loss_type == "cd1_sum_emd":
        dl, dr = chamfer_l1(pred, target)
        emd = emd_approx(pred, target) * pred.reshape(b, -1).shape[1]
        return torch.sum(dl) + torch.sum(dr) + torch.sum(emd)
    if loss_type == "cd_sum":
        dl, dr = chamfer_dist(pred, target)
        return dl.reshape(b, -1).sum(-1) + dr.reshape(b, -1).sum(-1)
    if loss_type == "chamfer":
        dl, dr = chamfer_dist(pred, target)
        return dl.reshape(b, -1).mean(-1) + dr.reshape(b, -1).mean(-1)
    if loss_type == "l1_cd":
        l1 = torch.sum(torch.abs(pred - target))
        dl, dr = chamfer_dist(pred, target)
        return l1 + torch.sum(dl) + torch.sum(dr)
    if loss_type == "emd":
        return emd_approx(pred, target)
    if loss_type == "chamfer_emd":
        dl, dr = chamfer_dist(pred, target)
        cd = dl.reshape(b, -1).mean(-1) + dr.reshape(b, -1).mean(-1)
        return cd + emd_approx(pred, target) * loss_weight_emd
    raise ValueError(loss_type)


def kl_coeff(step, total_step, constant_step, min_kl_coeff,
             max_kl_coeff=1.0):
    """KL annealing: min + (max - min) * (step - constant_step) /
    total_step, clamped to [min, max]."""
    coeff = (min_kl_coeff + (max_kl_coeff - min_kl_coeff)
             * (step - constant_step) / total_step)
    return max(min(coeff, max_kl_coeff), min_kl_coeff)


def kl_balancer_coeff(num_scales: int, groups_per_scale: Sequence[int],
                      fun: str = "square") -> torch.Tensor:
    """Per-group KL balancing coefficients: deeper scales get larger alpha,
    normalized so that the least is 1. Returns a (sum(groups),) float32
    tensor."""
    parts = []
    for i in range(num_scales):
        g = groups_per_scale[num_scales - i - 1]
        if fun == "equal":
            parts.append(np.ones(g))
        elif fun == "linear":
            parts.append((2.0 ** i) * np.ones(g))
        elif fun == "sqrt":
            parts.append(np.sqrt(2.0 ** i) * np.ones(g))
        elif fun == "square":
            parts.append(np.square(2.0 ** i) / g * np.ones(g))
        else:
            raise NotImplementedError(fun)
    coeff = np.concatenate(parts).astype(np.float32)
    return torch.from_numpy(coeff / coeff.min())


def kl_per_group(kl_all: torch.Tensor):
    """(B, G) -> ((1, G) smoothed per-group |KL| means, (G,) means)."""
    kl_vals = torch.mean(kl_all, dim=0)
    kl_coeff_i = torch.mean(torch.abs(kl_all), dim=0, keepdim=True) + 0.01
    return kl_coeff_i, kl_vals


def kl_balancer(kl_all: Sequence[torch.Tensor], kl_coeff: float = 1.0,
                kl_balance: bool = False,
                alpha_i: Optional[torch.Tensor] = None):
    """Group-balanced KL of the per-group (B,) terms `kl_all`.

    With kl_balance during the anneal (kl_coeff < 1) each group is weighted
    by its mean |KL| over alpha_i, renormalized to mean 1, without gradient
    through the weights. Returns (kl (B,) times kl_coeff, kl_coeffs (G,),
    kl_vals (G,))."""
    kl_stack = torch.stack(list(kl_all), dim=1)                # (B, G)
    if kl_balance and kl_coeff < 1.0:
        if alpha_i is None:
            raise ValueError("kl_balancer: kl_balance needs alpha_i")
        alpha = alpha_i.reshape(1, -1)
        kl_coeff_i, kl_vals = kl_per_group(kl_stack)
        total_kl = torch.sum(kl_coeff_i)
        kl_coeff_i = kl_coeff_i / alpha * total_kl
        kl_coeff_i = kl_coeff_i / torch.mean(kl_coeff_i, dim=1, keepdim=True)
        kl = torch.sum(kl_stack * kl_coeff_i.detach(), dim=1)
        kl_coeffs = kl_coeff_i[0]
    else:
        kl_vals = torch.mean(kl_stack, dim=0)
        kl = torch.sum(kl_stack, dim=1)
        kl_coeffs = torch.ones((kl_stack.shape[1],), dtype=torch.float32,
                               device=kl_stack.device)
    return kl_coeff * kl, kl_coeffs, kl_vals
