"""Point-Voxel Convolution, eval flow (port of lion_tpu/nn/pvconv.py).

The eval ("fused") flow of the JAX module without its TPU-only branches
(the megafused block and the packed conv pair):

    voxelize -> conv0 (+ stats) -> fold GN/AdaGN of conv0 into a per-channel
    affine -> conv1 with that affine + swish as its prologue (+ stats) ->
    fold the second norm and the SE gate (its pooled input is the grid mean,
    known from the stats) -> trilinear devoxelize -> per-channel affine

The norm after the last conv commutes with devoxelization (the trilinear
weights sum to 1 and the affine is per-channel), so it is applied to the
(B, N, C) points instead of the (B, R^3, C) grid. Then the per-point
SharedMLP branch is added and the optional LinearAttention applied.
"""
from __future__ import annotations

from torch import nn

from ..ops.voxel import trilinear_devoxelize, voxelize
from .common import SE, Conv3dSame, LinearAttention, Normalizer, SharedMLP


class PVConv(nn.Module):
    """PVConv with SE and the per-point branch (the configuration every
    PVConv of the model uses)."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 attention: bool = False, ada: bool = False,
                 style_dim: int = 128, init_scale: float = 1.0):
        super().__init__()
        self.resolution = resolution
        self.vconv0 = Conv3dSame(out_channels, in_channels)
        self.vnorm0 = Normalizer(out_channels, ada, style_dim, init_scale)
        self.vconv1 = Conv3dSame(out_channels, out_channels)
        self.vnorm1 = Normalizer(out_channels, ada, style_dim, init_scale)
        self.se = SE(out_channels)
        self.point_features = SharedMLP(in_channels, (out_channels,), ada,
                                        style_dim, init_scale)
        self.attn = LinearAttention(out_channels) if attention else None

    def forward(self, features, coords, style=None):
        """features (B, N, C_in), coords (B, N, >=3) -> (B, N, C_out)."""
        r = self.resolution
        count = float(r ** 3)   # the stats cover every cell, empty ones too
        grid, norm_coords = voxelize(features, coords[..., :3], r)
        y0, st0, b0 = self.vconv0(grid)
        sc0, bi0 = self.vnorm0.fold(style, st0, count, conv_bias=b0)
        y1, st1, b1 = self.vconv1(y0, in_affine=(sc0, bi0), pre_swish=True)
        sc1, bi1 = self.vnorm1.fold(style, st1, count, conv_bias=b1)
        # SE gate from the grid mean of the normed output, known from stats
        gate = self.se.gate(sc1 * (st1[:, 0, :] / count) + bi1)
        sc1, bi1 = sc1 * gate, bi1 * gate
        pts = trilinear_devoxelize(y1, norm_coords.contiguous(), r)
        fused = pts * sc1[:, None, :] + bi1[:, None, :]
        fused = fused + self.point_features(features, style)
        if self.attn is not None:
            fused = self.attn(fused)
        return fused
