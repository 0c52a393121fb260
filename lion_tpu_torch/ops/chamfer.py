"""Chamfer distance (port of lion_tpu/ops/chamfer.py).

For each point the min squared L2 distance to the other cloud, both ways,
with the argmin indices; and the L1 variant of the VAE loss. Plain PyTorch:
the JAX package computes these in XLA, outside any Pallas kernel.

The distances take the matmul form max((|a|^2 + |b|^2) - 2 a.b, 0) as one
product of augmented rows, [a, |a|^2, 1] . [-2b, 1, |b|^2], by
`torch.matmul` in full fp32 (TF32 off): the (..., N, M) result is written
once, where the op-by-op form would write it several times (at the metric
blocks' sizes one such array is gigabytes, and the passes over it are the
CD's time). The clamp at 0 is monotone, so where only the minima are read
it is applied to them.
"""
from __future__ import annotations

import torch

from ._cuda import no_tf32
from .interpolate import _sq_norm
from .rows import gather_rows


def sqdist_unclamped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., N, 3), b (..., M, 3), batch dims broadcast -> (..., N, M)
    matmul-form squared distances before the clamp at 0
    (lion_tpu/ops/points.py:89-100)."""
    a, b = a.float(), b.float()
    ones_a = torch.ones_like(a[..., :1])
    ones_b = torch.ones_like(b[..., :1])
    rows = torch.cat([a, _sq_norm(a)[..., None], ones_a], dim=-1)
    cols = torch.cat([-2.0 * b, ones_b, _sq_norm(b)[..., None]], dim=-1)
    with no_tf32():
        return torch.matmul(rows, cols.transpose(-1, -2))


def sqdist_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`sqdist_unclamped` clamped at 0."""
    return sqdist_unclamped(a, b).clamp_min_(0.0)


def chamfer(a: torch.Tensor, b: torch.Tensor):
    """a (B, N, 3), b (B, M, 3) -> (dist_a (B, N), dist_b (B, M),
    idx_a (B, N) int32, idx_b (B, M) int32); squared L2. The clamp comes
    before the argmins, so coincident points tie at 0 as in JAX."""
    d2 = sqdist_mm(a, b)
    dist_a, idx_a = d2.min(dim=-1)
    dist_b, idx_b = d2.min(dim=-2)
    return dist_a, dist_b, idx_a.to(torch.int32), idx_b.to(torch.int32)


def chamfer_dist(a: torch.Tensor, b: torch.Tensor):
    """Squared-L2 chamfer distances only: (B, N), (B, M); differentiable
    (the clamp is out of place: amin's backward reads its output)."""
    d2 = sqdist_unclamped(a, b)
    return d2.amin(dim=-1).clamp_min(0.0), d2.amin(dim=-2).clamp_min(0.0)


def chamfer_l1(a: torch.Tensor, b: torch.Tensor):
    """The reference `cd1_sum` loss: nearest neighbours by squared L2 over
    xyz, then |a - b_nn| summed over all coords and points, per direction
    -> two (B,) losses."""
    d2 = sqdist_mm(a[..., :3], b[..., :3])
    idx_a = d2.argmin(dim=-1)
    idx_b = d2.argmin(dim=-2)
    # the gathers' gradients sum in fixed order (rows.gather_rows)
    b_nn, a_nn = gather_rows(b, idx_a), gather_rows(a, idx_b)
    return ((a - b_nn).abs().sum(dim=(-1, -2)),
            (b - a_nn).abs().sum(dim=(-1, -2)))
