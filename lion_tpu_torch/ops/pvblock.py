"""The whole voxel branch of a PVConv in one launch (port of
pvconv_block_pair, lion_tpu/ops/pallas/pvblock.py:264).

Kernel here:
  K9 `pvconv_block_pair` (csrc/pvblock.cu).

    voxelize -> conv0 -> GroupNorm fold -> swish -> conv1 -> devoxelize

in bf16 at r = 8, C = 128, with the semantics of the K3 -> K8 -> K5 chain:
the grid is the float32 mean rounded to bf16; conv0 and conv1 multiply bf16
values with float32 sums and round to bf16; the fold takes the statistics
of the rounded conv0 output (conv3d.gn_affine_from_stats); the devoxelized
points are bf16. Returns the points and the (sum, sumsq) of the rounded conv1
output, which the caller folds with the next norm, as after K8.

The kernel is a cluster of 8 blocks per item on K4's bf16 brick tile: the
8 blocks are conv_plan's grid for (b, 8, 128, 128, bf16), 4 bricks of two
8 x 8 planes by 2 tiles of 64 output channels, and the item's statistics
are the sum of the 4 bricks' partials in rank order.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of
from .conv3d import _conv3d_pair_plain
from .voxel import _avg_voxelize_plain, _trilinear_devoxelize_plain

BLOCK_R, BLOCK_C, BLOCK_MAX_N = 8, 128, 4096


def supports_block_pair(r: int, c: int, n: int) -> bool:
    """The one shape the kernel takes (the JAX dispatch set, pvblock.py:66):
    r = 8, C = 128, N a multiple of 8 and at most 4096."""
    return (r == BLOCK_R and c == BLOCK_C and n % 8 == 0
            and 0 < n <= BLOCK_MAX_N)


def _pvconv_block_pair_plain(features, vox_coords, norm_coords, w0, b0, ca,
                             cb, w1, r):
    grid = _avg_voxelize_plain(features, vox_coords, r)
    y1, st1 = _conv3d_pair_plain(grid, w0, b0, ca, cb, w1)
    return _trilinear_devoxelize_plain(y1, norm_coords, r), st1


@kernel("pvconv_block_pair", _pvconv_block_pair_plain,
        "lion_tpu_torch/csrc/pvblock.cu",
        "lion_tpu/ops/pallas/pvblock.py:264")
def pvconv_block_pair(features: torch.Tensor, vox_coords: torch.Tensor,
                      norm_coords: torch.Tensor, w0: torch.Tensor,
                      b0: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor,
                      w1: torch.Tensor, r: int):
    """features (B, N, C) bf16, vox_coords (B, N, 3) int32, norm_coords
    (B, N, 3) f32 in [0, r-1]; w0, w1 (3, 3, 3, C, C) bf16; b0 (C,) f32;
    ca, cb (B, C) f32 -> (points (B, N, C) bf16, st1 (B, 2, C) f32)."""
    b, n, c = features.shape
    if not supports_block_pair(r, c, n):
        raise ValueError(f"pvconv_block_pair: r={r}, C={c}, N={n} (takes "
                         f"r={BLOCK_R}, C={BLOCK_C}, N % 8 == 0, "
                         f"N <= {BLOCK_MAX_N})")
    check_cuda(features, w0, w1, dtype=torch.bfloat16)
    dev = features.device
    check_cuda(vox_coords, dtype=torch.int32, device=dev)
    check_cuda(norm_coords, b0, ca, cb, device=dev)
    if w0.shape != (3, 3, 3, c, c) or w1.shape != w0.shape:
        raise ValueError(f"pvconv_block_pair: w0 {tuple(w0.shape)}, "
                         f"w1 {tuple(w1.shape)}")
    scratch = torch.empty((2, b, r ** 3, c), dtype=torch.bfloat16,
                          device=dev)
    out = torch.empty_like(features)
    st1 = torch.empty((b, 2, c), device=dev)
    launch("lion_pvconv_block_pair", ptr(features), ptr(vox_coords),
           ptr(norm_coords), ptr(w0), ptr(b0), ptr(ca), ptr(cb), ptr(w1),
           ptr(scratch), ptr(out), ptr(st1), b, n, c, r, stream_of(features))
    return out, st1
