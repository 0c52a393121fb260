"""Point sampling and grouping ops (port of lion_tpu/ops/points.py).

Channels-last like the JAX package: coords (B, N, 3), features (B, N, C).

Kernels here:
  K1 `fps` (csrc/fps.cu): furthest point sampling, indices and the picked
     coords in one launch.
  K2 `ball_query_group` (csrc/ball_query_group.cu): ball query fused with
     the grouping gather, forward only.

Each plain version computes squared distances op by op as
((dx*dx + dy*dy) + dz*dz), the order the kernels use with unfused
arithmetic, so kernel and plain version pick the same indices bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3), (..., N, 3) -> (..., M, N) exact subtract-square form."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# --------------------------------------------------------------------------
# K1: furthest point sampling
# --------------------------------------------------------------------------
def _fps_plain(coords: torch.Tensor, num_samples: int):
    """coords (B, N, 3) -> (idx (B, M) int32, centers (B, M, 3)).

    Index 0 seeds the chain; each next pick is the argmax of the running
    min squared distance (torch.argmax returns the first maximum, so ties
    go to the lowest index)."""
    b, n, _ = coords.shape
    xyz = coords.float()
    rows = torch.arange(b, device=xyz.device)
    min_d2 = torch.full((b, n), float("inf"), device=xyz.device)
    idx = torch.zeros((b, num_samples), dtype=torch.long, device=xyz.device)
    last = idx[:, 0]
    for i in range(1, num_samples):
        d = xyz - xyz[rows, last][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=1)
        idx[:, i] = last
    centers = torch.gather(xyz, 1, idx[:, :, None].expand(-1, -1, 3))
    return idx.to(torch.int32), centers


@kernel("fps", _fps_plain, "lion_tpu_torch/csrc/fps.cu",
        "lion_tpu/ops/pallas/fps.py:112")
def fps(coords: torch.Tensor, num_samples: int):
    """coords (B, N, 3) -> (idx (B, M) int32, centers (B, M, 3) f32)."""
    check_cuda(coords)
    b, n, _ = coords.shape
    if not 1 <= num_samples <= n or 16 * n > 227 * 1024:
        raise ValueError(f"fps: unsupported N={n}, M={num_samples}")
    idx = torch.empty((b, num_samples), dtype=torch.int32, device=coords.device)
    centers = torch.empty((b, num_samples, 3), device=coords.device)
    launch("lion_fps", ptr(coords), ptr(idx), ptr(centers), b, n,
           num_samples, stream_of(coords))
    return idx, centers


def furthest_point_sample_idx(coords: torch.Tensor,
                              num_samples: int) -> torch.Tensor:
    """coords (B, N, 3) -> (B, num_samples) int32 indices."""
    return fps(coords.detach().contiguous(), num_samples)[0]


def furthest_point_sample(coords: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """coords (B, N, 3) -> sampled centers (B, num_samples, 3)."""
    return fps(coords.detach().contiguous(), num_samples)[1]


# --------------------------------------------------------------------------
# grouping / gather
# --------------------------------------------------------------------------
def grouping(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), indices (B, M, K) -> (B, M, K, C)."""
    b, _, c = features.shape
    _, m, k = indices.shape
    flat = indices.reshape(b, m * k).long()
    out = torch.gather(features, 1, flat[:, :, None].expand(-1, -1, c))
    return out.reshape(b, m, k, c)


def gather(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), indices (B, M) -> (B, M, C)."""
    idx = indices.long()[:, :, None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, idx)


# --------------------------------------------------------------------------
# K2: ball query + grouping
# --------------------------------------------------------------------------
def _r2(radius: float) -> float:
    """The squared radius as the JAX forms compute it: float32(r) ** 2."""
    return float(np.float32(radius) * np.float32(radius))


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """centers (B, M, 3), points (B, N, 3) -> (B, M, K) int64 indices.

    The first K points with d2 < r^2 in index order; partial rows repeat
    the first hit, empty rows are all 0 (ball_query.cu semantics)."""
    n = points.shape[1]
    d2 = _sq_dist(centers.float(), points.float())           # (B, M, N)
    mask = d2 < _r2(radius)
    iota = torch.arange(n, device=points.device).expand_as(d2)
    key = torch.where(mask, iota, iota + n)
    kth = torch.topk(key, num_neighbors, dim=-1, largest=False,
                     sorted=True).values
    valid = kth < n
    idx = torch.where(valid, kth, torch.zeros_like(kth))
    return torch.where(valid, idx, idx[..., :1].expand_as(idx))


def _ball_query_group_plain(points_coords, centers_coords, points_features,
                            radius: float, num_neighbors: int):
    idx = ball_query(centers_coords, points_coords, radius, num_neighbors)
    rel = grouping(points_coords.float(), idx) - centers_coords[:, :, None, :]
    feats = grouping(points_features.float(), idx)
    return torch.cat([rel, feats], dim=-1)


@kernel("ball_query_group", _ball_query_group_plain,
        "lion_tpu_torch/csrc/ball_query_group.cu",
        "lion_tpu/ops/pallas/ball_query_group.py:283")
def ball_query_group(points_coords: torch.Tensor,
                     centers_coords: torch.Tensor,
                     points_features: torch.Tensor, radius: float,
                     num_neighbors: int) -> torch.Tensor:
    """points (B, N, 3), centers (B, M, 3), features (B, N, C) ->
    (B, M, K, 3 + C): [center-relative xyz ++ features] per neighbour."""
    check_cuda(points_coords, centers_coords, points_features)
    b, n, _ = points_coords.shape
    m = centers_coords.shape[1]
    c = points_features.shape[-1]
    k = num_neighbors
    out = torch.empty((b, m, k, 3 + c), device=points_coords.device)
    launch("lion_ball_query_group", ptr(points_coords), ptr(centers_coords),
           ptr(points_features), ptr(out), b, n, m, c, k, _r2(radius),
           stream_of(points_coords))
    return out
