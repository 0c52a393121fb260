"""Plain PyTorch point-cloud operations of the reference: furthest point
sampling, ball query and grouping, three-nearest-neighbour interpolation,
average voxelization, trilinear devoxelization and the 3x3x3 SAME
convolution, channels-last as the model keeps its tensors: points
(B, N, C), grids (B, R, R, R, C).

Written from the operations' definitions (PVCNN's voxelization, PointNet++'s
sampling, grouping and interpolation) with no kernel: every gradient is
autograd's. Coordinates carry no gradient where the published operations
stop it (the sampled centers, the voxel and trilinear coordinates, the
interpolation weights). Squared distances are formed op by op,
((dx*dx + dy*dy) + dz*dz), so that the discrete choices (which point is
furthest, which lies in a ball, which voxel a point falls in) do not turn
on a device's fused arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sq(d: torch.Tensor) -> torch.Tensor:
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
            + d[..., 2] * d[..., 2])


def furthest_point_sample(coords: torch.Tensor, m: int) -> torch.Tensor:
    """coords (B, N, 3) -> centers (B, m, 3): index 0 first, then each time
    the point furthest from those picked (ties to the lowest index)."""
    xyz = coords.detach().float()
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    min_d2 = torch.full((b, n), float("inf"), device=xyz.device)
    idx = torch.zeros((b, m), dtype=torch.long, device=xyz.device)
    last = idx[:, 0]
    for i in range(1, m):
        min_d2 = torch.minimum(min_d2, _sq(xyz - xyz[rows, last][:, None, :]))
        last = torch.argmax(min_d2, dim=1)
        idx[:, i] = last
    return torch.gather(xyz, 1, idx[:, :, None].expand(-1, -1, 3))


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               k: int) -> torch.Tensor:
    """(B, M, K) indices: the first K points (in index order) with squared
    distance below float32(radius)^2; a row with fewer repeats its first
    hit, an empty row is all 0."""
    n = points.shape[1]
    r2 = float(np.float32(radius) * np.float32(radius))
    d2 = _sq(centers.detach().float()[:, :, None, :]
             - points.detach().float()[:, None, :, :])
    iota = torch.arange(n, device=points.device).expand_as(d2)
    key = torch.where(d2 < r2, iota, iota + n)
    first = torch.topk(key, min(k, n), dim=-1, largest=False,
                       sorted=True).values
    first = F.pad(first, (0, k - first.shape[-1]), value=n)
    hit = first < n
    idx = torch.where(hit, first, torch.zeros_like(first))
    return torch.where(hit, idx, idx[..., :1].expand_as(idx))


def group(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k)[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, m, k, x.shape[-1])


def ball_group(points: torch.Tensor, centers: torch.Tensor,
               features: torch.Tensor, radius: float, k: int):
    """[neighbour xyz - center ++ neighbour features] (B, M, K, 3 + C)."""
    idx = ball_query(centers, points, radius, k)
    rel = group(points, idx) - centers[:, :, None, :]
    return torch.cat([rel, group(features, idx)], dim=-1)


def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         feats: torch.Tensor) -> torch.Tensor:
    """Inverse-squared-distance weights of each point's three nearest
    centers (ties to the lowest index; with M < 3 the missing neighbours
    weigh nothing) -> (B, N, C)."""
    with torch.no_grad():
        p, c = points.float(), centers.float()
        dot = (p[:, :, None, 0] * c[:, None, :, 0]
               + p[:, :, None, 1] * c[:, None, :, 1]
               + p[:, :, None, 2] * c[:, None, :, 2])
        d2 = torch.clamp_min((_sq(p)[:, :, None] + _sq(c)[:, None, :])
                             - 2.0 * dot, 0.0)
        m = d2.shape[-1]
        ds, ids = [], []
        work = d2
        for j in range(3):
            if j < m:
                i = torch.argmin(work, dim=-1)
                ds.append(torch.gather(work, -1, i[..., None])[..., 0])
                work = work.scatter(-1, i[..., None], float("inf"))
            else:
                i = torch.zeros(d2.shape[:2], dtype=torch.long,
                                device=d2.device)
                ds.append(torch.full(d2.shape[:2], 1e10, device=d2.device))
            ids.append(i)
        d = [torch.clamp(x, 1e-10, 1e10) for x in ds]
        inv = 1.0 / (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])
        ws = (d[1] * d[2] * inv, d[0] * d[2] * inv, d[0] * d[1] * inv)
    c_dim = feats.shape[-1]
    out = 0.0
    for i, w in zip(ids, ws):
        out = out + torch.gather(
            feats, 1, i[:, :, None].expand(-1, -1, c_dim)) * w[..., None]
    return out


def normalize_coords(coords: torch.Tensor, r: int) -> torch.Tensor:
    """PVCNN's voxel coordinates in [0, r - 1]: each cloud centred on its
    mean (summed in float64), divided by twice its largest norm, shifted
    by 0.5, scaled by r and clamped."""
    c = coords.detach().float()
    c = c - c.double().mean(dim=1, keepdim=True).float()
    norm = torch.sqrt(_sq(c))[..., None]
    c = c / (norm.amax(dim=1, keepdim=True) * 2.0) + 0.5
    return torch.clamp(c * r, 0.0, r - 1)


def voxelize(features: torch.Tensor, coords: torch.Tensor, r: int):
    """(grid (B, R, R, R, C): the mean feature of the points in each voxel,
    0 where none; the voxel coordinates (B, N, 3))."""
    b, _, c = features.shape
    nc = normalize_coords(coords, r)
    v = torch.round(nc).long()
    flat = (v[..., 0] * r + v[..., 1]) * r + v[..., 2]
    total = features.new_zeros((b, r ** 3, c)).scatter_add(
        1, flat[:, :, None].expand(-1, -1, c), features)
    count = features.new_zeros((b, r ** 3)).scatter_add(
        1, flat, torch.ones_like(flat, dtype=features.dtype))
    grid = total / count.clamp(min=1.0)[:, :, None]
    return grid.reshape(b, r, r, r, c), nc


def devoxelize(grid: torch.Tensor, nc: torch.Tensor, r: int) -> torch.Tensor:
    """Trilinear interpolation of the grid at the voxel coordinates."""
    b, c = grid.shape[0], grid.shape[-1]
    flat = grid.reshape(b, r ** 3, c)
    lo = torch.floor(nc)
    frac = nc - lo
    lo = lo.long().clamp(0, r - 1)
    hi = (lo + (frac > 0).long()).clamp(max=r - 1)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = (hi if dx else lo)[..., 0]
                iy = (hi if dy else lo)[..., 1]
                iz = (hi if dz else lo)[..., 2]
                w = ((frac[..., 0] if dx else 1.0 - frac[..., 0])
                     * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                     * (frac[..., 2] if dz else 1.0 - frac[..., 2]))
                cell = (ix * r + iy) * r + iz
                out = out + torch.gather(
                    flat, 1, cell[:, :, None].expand(-1, -1, c)) * w[..., None]
    return out


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME convolution, bias-free: x (B, R, R, R, Ci),
    w (3, 3, 3, Ci, Co) -> (B, R, R, R, Co)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)
