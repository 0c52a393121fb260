"""3-nearest-neighbour inverse-distance interpolation (port of
lion_tpu/ops/interpolate.py).

Kernel here:
  K6 `nearest_neighbor_interpolate` (csrc/three_nn.cu).

The plain version evaluates the distances and the weighted sum op by op in
the order the kernel uses with unfused arithmetic, so both pick the same
neighbours and agree bit for bit on the card.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def pairwise_sqdist(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (B, N, M): max((|p|^2 + |c|^2) - 2 p.c, 0),
    the matmul form the JAX package uses."""
    p = points.float()[:, :, None, :]
    c = centers.float()[:, None, :, :]
    dot = p[..., 0] * c[..., 0] + p[..., 1] * c[..., 1] + p[..., 2] * c[..., 2]
    p2 = _sq_norm(points.float())[:, :, None]
    c2 = _sq_norm(centers.float())[:, None, :]
    return torch.clamp_min((p2 + c2) - 2.0 * dot, 0.0)


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """points (B, N, 3), centers (B, M, 3) -> (d2 (B, N, 3), idx (B, N, 3)).

    Three masked argmin sweeps; ties go to the lowest index. With M < 3 the
    missing slots get index 0 and d2 = 1e10 (the CUDA initializer)."""
    d2 = pairwise_sqdist(points, centers)
    m = d2.shape[-1]
    dists, idxs = [], []
    work = d2
    for j in range(3):
        if j < m:
            idx_j = torch.argmin(work, dim=-1)
            d_j = torch.gather(work, -1, idx_j[..., None])[..., 0]
            if j < 2:
                work = work.scatter(-1, idx_j[..., None], float("inf"))
        else:
            idx_j = torch.zeros(d2.shape[:2], dtype=torch.long,
                                device=d2.device)
            d_j = torch.full(d2.shape[:2], 1e10, device=d2.device)
        dists.append(d_j)
        idxs.append(idx_j)
    return torch.stack(dists, -1), torch.stack(idxs, -1)


def _nearest_neighbor_interpolate_plain(points, centers, centers_features):
    d2, idx = three_nn(points, centers)
    d2 = torch.clamp(d2, 1e-10, 1e10)
    d0, d1, d2_ = d2[..., 0], d2[..., 1], d2[..., 2]
    d0d1, d0d2, d1d2 = d0 * d1, d0 * d2_, d1 * d2_
    inv = 1.0 / (d0d1 + d0d2 + d1d2)
    feats = centers_features.float()
    c = feats.shape[-1]
    out = None
    for j, w in enumerate((d1d2 * inv, d0d2 * inv, d0d1 * inv)):
        f = torch.gather(feats, 1, idx[..., j:j + 1].expand(-1, -1, c))
        term = f * w[..., None]
        out = term if out is None else out + term
    return out


@kernel("three_nn_interpolate", _nearest_neighbor_interpolate_plain,
        "lion_tpu_torch/csrc/three_nn.cu",
        "lion_tpu/ops/pallas/three_nn.py:74")
def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 centers_features: torch.Tensor):
    """points (B, N, 3), centers (B, M, 3), centers_features (B, M, C) ->
    (B, N, C)."""
    check_cuda(points, centers, centers_features)
    b, n, _ = points.shape
    m, c = centers_features.shape[1], centers_features.shape[2]
    if m < 1:
        raise ValueError("nearest_neighbor_interpolate needs M >= 1")
    out = torch.empty((b, n, c), device=points.device)
    launch("lion_three_nn_interpolate", ptr(points), ptr(centers),
           ptr(centers_features), ptr(out), b, n, m, c, stream_of(points))
    return out
