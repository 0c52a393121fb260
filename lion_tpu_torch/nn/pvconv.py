"""Point-Voxel Convolution (port of lion_tpu/nn/pvconv.py).

In train mode (`self.training`) the modular flow of the JAX module
(lion_tpu/nn/pvconv.py:141-150), differentiable:
  voxelize -> conv0 + b -> norm -> swish -> dropout -> conv1 + b -> norm
  -> SE -> devoxelize,
with the convs on K10 (`Conv3dSame.modular`) in the compute dtype (bf16
under `tpu.bf16`, else the features' dtype). As in the eval flow, each
norm runs in float32 and is rounded once to the compute dtype after its
swish or the SE gate, where the JAX module rounds after the norm too.

In eval mode the eval ("fused") flow of the JAX module, with its three
voxel branches (lion_tpu/nn/pvconv.py:56-128) kept as fixed shape
predicates:

  * bf16 at r = 8, C = 128, Cin == Cout (N % 8 == 0, N <= 4096): the whole
    branch in one kernel, voxelize -> conv pair -> devoxelize (K9,
    ops/pvblock.py);
  * bf16 at r = 32, C = 64, Cin == Cout: voxelize -> the conv pair in one
    entry (K8, ops/conv3d.py conv3d_pair) -> devoxelize;
  * otherwise the chain
      voxelize -> conv0 (+ stats) -> fold GN/AdaGN of conv0 into a
      per-channel affine -> conv1 with that affine + swish as its prologue
      (+ stats) -> devoxelize.

Then the second norm and the SE gate (its pooled input is the grid mean,
known from the stats) fold into a per-channel affine. The norm after the
last conv commutes with devoxelization (the trilinear weights sum to 1 and
the affine is per-channel), so it is applied to the (B, N, C) points
instead of the (B, R^3, C) grid: in K5's epilogue, before its one rounding
to the compute dtype, or after K9. Then the per-point SharedMLP branch is
added and the optional LinearAttention applied.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.conv3d import conv3d_pair
from ..ops.pvblock import pvconv_block_pair, supports_block_pair
from ..ops.voxel import normalize_coords, trilinear_devoxelize, voxelize
from .common import (SE, Conv3dSame, Dropout, LinearAttention, Normalizer,
                     SharedMLP, swish)

PAIR_R, PAIR_C = 32, 64   # the conv pair's shape (conv3d_packed.py:603)


class PVConv(nn.Module):
    """PVConv with SE and the per-point branch (the configuration every
    PVConv of the model uses)."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 attention: bool = False, ada: bool = False,
                 style_dim: int = 128, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.resolution = resolution
        self.dtype = dtype
        self.drop = Dropout(dropout)
        self.vconv0 = Conv3dSame(out_channels, in_channels)
        self.vnorm0 = Normalizer(out_channels, ada, style_dim, init_scale)
        self.vconv1 = Conv3dSame(out_channels, out_channels)
        self.vnorm1 = Normalizer(out_channels, ada, style_dim, init_scale)
        self.se = SE(out_channels)
        self.point_features = SharedMLP(in_channels, (out_channels,), ada,
                                        style_dim, init_scale, dtype=dtype)
        self.attn = LinearAttention(out_channels, dtype=dtype) \
            if attention else None

    def _pair_args(self, style, batch, dt):
        ca0, cb0 = self.vnorm0.channel_affine(style, batch)
        return (self.vconv0.kernel.detach().to(dt), self.vconv0.bias,
                ca0.contiguous(), cb0.contiguous(),
                self.vconv1.kernel.detach().to(dt))

    def _voxel_branch_train(self, features, xyz, style):
        r, dt = self.resolution, self.dtype or features.dtype
        grid, norm_coords = voxelize(features, xyz, r)
        h = self.vconv0.modular(grid, dt)
        h = swish(self.vnorm0(h, style)).to(dt)
        h = self.vconv1.modular(self.drop(h), dt)
        h = self.se(self.vnorm1(h, style)).to(dt)
        return trilinear_devoxelize(h, norm_coords.contiguous(), r)

    def forward(self, features, coords, style=None):
        """features (B, N, C_in), coords (B, N, >=3) -> (B, N, C_out)."""
        if self.training:
            fused = self._voxel_branch_train(features, coords[..., :3],
                                             style)
            return self._point_branch(fused, features, style)
        r = self.resolution
        b, n, cin = features.shape
        cout = self.vconv1.kernel.shape[-1]
        dt = self.dtype or features.dtype
        bf16_pair = dt == torch.bfloat16 and cin == cout
        count = float(r ** 3)   # the stats cover every cell, empty ones too
        xyz = coords[..., :3]
        if bf16_pair and supports_block_pair(r, cin, n):
            norm_coords = normalize_coords(xyz, r).contiguous()
            w0, b0, ca0, cb0, w1 = self._pair_args(style, b, dt)
            pts, st1 = pvconv_block_pair(
                features.to(dt).contiguous(),
                torch.round(norm_coords).to(torch.int32), norm_coords, w0,
                b0, ca0, cb0, w1, r)
            sc1, bi1 = self._out_affine(style, st1, count)
            fused = (pts.float() * sc1[:, None, :] + bi1[:, None, :]).to(dt)
        else:
            grid, norm_coords = voxelize(features, xyz, r)
            grid = grid.to(dt)
            if bf16_pair and (r, cin) == (PAIR_R, PAIR_C):
                y1, st1 = conv3d_pair(grid, *self._pair_args(style, b, dt))
            else:
                y0, st0, b0 = self.vconv0(grid)
                sc0, bi0 = self.vnorm0.fold(style, st0, count, conv_bias=b0)
                y1, st1, _ = self.vconv1(y0, in_affine=(sc0, bi0),
                                         pre_swish=True)
            # the affine in K5's epilogue, before its one rounding
            fused = trilinear_devoxelize(y1, norm_coords.contiguous(), r,
                                         *self._out_affine(style, st1, count))
        return self._point_branch(fused, features, style)

    def _out_affine(self, style, st1, count):
        """The second norm and the SE gate folded into one per-(item,
        channel) affine (B, C) f32; the gate's pooled input is the grid mean
        of the normed output, known from the statistics."""
        sc1, bi1 = self.vnorm1.fold(style, st1, count,
                                    conv_bias=self.vconv1.bias)
        gate = self.se.gate(sc1 * (st1[:, 0, :] / count) + bi1)
        return sc1 * gate, bi1 * gate

    def _point_branch(self, fused, features, style):
        fused = fused + self.point_features(features, style)
        if self.attn is not None:
            fused = self.attn(fused)
        return fused
