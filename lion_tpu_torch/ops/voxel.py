"""Voxelization / devoxelization ops (port of lion_tpu/ops/voxel.py).

Channels-last like the JAX package: grids are (B, R, R, R, C).

Kernels here:
  K3 `avg_voxelize` (csrc/voxelize.cu): scatter-mean of point features.
  K5 `trilinear_devoxelize` (csrc/devoxelize.cu): 8-corner trilinear
     gather.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of


def normalize_coords(coords: torch.Tensor, resolution: int) -> torch.Tensor:
    """coords (B, N, 3) -> continuous voxel coords (B, N, 3) in [0, r-1].

    Mean-centre each cloud, divide by twice the largest point norm, shift
    by 0.5, scale by r and clamp (models/pvcnn2.py Voxelization). The mean
    is summed in float64 and the norms op by op, so the result does not
    depend on a device's reduction order and a point rounds to the same
    voxel on the CPU and on the card."""
    coords = coords.detach().float()
    c = coords - coords.double().mean(dim=1, keepdim=True).float()
    norm = torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                      + c[..., 2] * c[..., 2])[..., None]
    normed = c / (norm.amax(dim=1, keepdim=True) * 2.0) + 0.5
    return torch.clamp(normed * resolution, 0.0, resolution - 1)


# --------------------------------------------------------------------------
# K3: average voxelization
# --------------------------------------------------------------------------
def _avg_voxelize_plain(features: torch.Tensor, vox_coords: torch.Tensor,
                        resolution: int) -> torch.Tensor:
    b, _, c = features.shape
    r = resolution
    v = vox_coords.long()
    flat = (v[..., 0] * r + v[..., 1]) * r + v[..., 2]       # (B, N)
    grid = features.new_zeros((b, r ** 3, c), dtype=torch.float32)
    grid.scatter_add_(1, flat[:, :, None].expand(-1, -1, c), features.float())
    count = grid.new_zeros((b, r ** 3))
    count.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    grid = grid / count.clamp(min=1.0)[:, :, None]
    return grid.reshape(b, r, r, r, c)


@kernel("avg_voxelize", _avg_voxelize_plain,
        "lion_tpu_torch/csrc/voxelize.cu",
        "lion_tpu/ops/pallas/voxelize.py:107")
def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """features (B, N, C), vox_coords (B, N, 3) int32 in [0, r) ->
    (B, R, R, R, C); a point outside the grid is dropped."""
    check_cuda(features)
    check_cuda(vox_coords, dtype=torch.int32)
    b, n, c = features.shape
    r = resolution
    grid = torch.zeros((b, r, r, r, c), device=features.device)
    count = torch.zeros((b, r ** 3), device=features.device)
    launch("lion_avg_voxelize", ptr(features), ptr(vox_coords), ptr(grid),
           ptr(count), b, n, c, r, stream_of(features))
    return grid


def voxelize(features: torch.Tensor, coords: torch.Tensor, resolution: int):
    """features (B, N, C), coords (B, N, 3) ->
    (grid (B, R, R, R, C), norm_coords (B, N, 3) in [0, r-1])."""
    norm_coords = normalize_coords(coords, resolution)
    # torch.round rounds half to even, like jnp.round
    vox_coords = torch.round(norm_coords).to(torch.int32)
    return (avg_voxelize(features.contiguous(), vox_coords, resolution),
            norm_coords)


# --------------------------------------------------------------------------
# K5: trilinear devoxelization
# --------------------------------------------------------------------------
def _trilinear_devoxelize_plain(grid: torch.Tensor, norm_coords: torch.Tensor,
                                resolution: int) -> torch.Tensor:
    r = resolution
    b, c = grid.shape[0], grid.shape[-1]
    flat_grid = grid.reshape(b, r ** 3, c)
    coords = norm_coords.detach().float()
    lo = torch.floor(coords)
    frac = coords - lo
    lo_i = lo.long()
    hi_i = lo_i + (frac > 0).long()  # hi collapses onto lo when frac == 0
    out = torch.zeros((b, coords.shape[1], c), dtype=grid.dtype,
                      device=grid.device)
    for dx in (0, 1):
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        ix = hi_i[..., 0] if dx else lo_i[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            iy = hi_i[..., 1] if dy else lo_i[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
                iz = hi_i[..., 2] if dz else lo_i[..., 2]
                idx = (ix * r + iy) * r + iz                  # (B, N)
                corner = torch.gather(flat_grid, 1,
                                      idx[:, :, None].expand(-1, -1, c))
                out = out + corner * (wx * wy * wz)[:, :, None]
    return out


@kernel("trilinear_devoxelize", _trilinear_devoxelize_plain,
        "lion_tpu_torch/csrc/devoxelize.cu",
        "lion_tpu/ops/pallas/devox.py:117")
def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         resolution: int) -> torch.Tensor:
    """grid (B, R, R, R, C), norm_coords (B, N, 3) f32 -> (B, N, C)."""
    check_cuda(grid, norm_coords)
    b, c = grid.shape[0], grid.shape[-1]
    n = norm_coords.shape[1]
    out = torch.empty((b, n, c), device=grid.device)
    launch("lion_trilinear_devoxelize", ptr(grid), ptr(norm_coords), ptr(out),
           b, n, c, resolution, stream_of(grid))
    return out
