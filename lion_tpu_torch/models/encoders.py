"""VAE encoders and decoder (port of lion_tpu/models/encoders.py).

  - PointNetPlusEncoder: the global style encoder, a two-stage plain
    (GroupNorm) SA stack, a max over the points and a dense layer to
    (mu, log_sigma) of the 128-d style.
  - PointTransPVC: the latent-points encoder, an AdaGN U-Net giving each
    point's posterior (mu, log_sigma) with the residual pt_mu = skip_weight
    * out + x.
  - LatentPointDecPVC: the decoder.

Parameter names are the flax paths of the JAX modules.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.common import TDense
from ..nn.pointnet import PointNetSAModule
from ..nn.pvconv import PVConv
from ..nn.unet import PVCNN2Unet, build_sa_stages

# sa_blocks spec: models/shapelatent_modules.py:14-17
STYLE_ENCODER_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 32))),
    ((32, 1, 16), (256, 0.2, 32, (32, 64))),
)

# specs: models/latent_points_ada.py:177-188 (shared by encoder and decoder)
LATENT_PTS_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 3, 16), (256, 0.2, 32, (64, 128))),
    ((128, 3, 8), (64, 0.4, 32, (128, 256))),
    (None, (16, 0.8, 32, (128, 128, 128))),
)
LATENT_PTS_FP_BLOCKS = (
    ((128, 128), (128, 3, 8)),
    ((128, 128), (128, 3, 8)),
    ((128, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 2, 32)),
)


class PointNetPlusEncoder(nn.Module):
    """Global style encoder: the plain SA stack, a max over the points and a
    dense layer (lion_tpu/models/encoders.py:43-73)."""

    def __init__(self, zdim: int, input_dim: int = 3, dropout: float = 0.1,
                 vres_mult: float = 1.0, ncenter_mult: float = 1.0):
        super().__init__()
        self.zdim = zdim
        self.stages, channels = build_sa_stages(
            STYLE_ENCODER_SA_BLOCKS, 0, input_dim, vres_mult=vres_mult,
            ncenter_mult=ncenter_mult)
        c = input_dim
        for i, stage in enumerate(self.stages):
            for j, spec in enumerate(stage.convs):
                self.add_module(f"sa{i}_conv{j}", PVConv(
                    c, spec.out_channels, spec.resolution,
                    attention=spec.attention, dropout=dropout))
                c = spec.out_channels
            s = stage.sa
            mod = PointNetSAModule(s.num_centers, s.radius, s.num_neighbors,
                                   c, s.out_channels)
            self.add_module(f"sa{i}_sa", mod)
            c = mod.out_channels
        self.mlp = TDense(zdim * 2, channels)

    def forward(self, x):
        """x (B, N, input_dim) -> (mu, log_sigma), each (B, zdim)."""
        features, coords = x, x
        for i, stage in enumerate(self.stages):
            for j in range(len(stage.convs)):
                features = getattr(self, f"sa{i}_conv{j}")(features, coords)
            features, coords = getattr(self, f"sa{i}_sa")(features, coords)
        out = self.mlp(features.amax(dim=1))
        return out[:, :self.zdim], out[:, self.zdim:]


class PointTransPVC(nn.Module):
    """Latent-points encoder: AdaGN U-Net -> per-point posterior parameters
    (lion_tpu/models/encoders.py:76-120)."""

    def __init__(self, zdim: int, input_dim: int = 3, style_dim: int = 128,
                 skip_weight: float = 0.1, pts_sigma_offset: float = 0.0,
                 dropout: float = 0.1, ada_mlp_init_scale: float = 1.0,
                 vres_mult: float = 1.0, ncenter_mult: float = 1.0,
                 sa_blocks=LATENT_PTS_SA_BLOCKS,
                 fp_blocks=LATENT_PTS_FP_BLOCKS,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.zdim, self.input_dim = zdim, input_dim
        self.skip_weight = skip_weight
        self.pts_sigma_offset = pts_sigma_offset
        self.layers = PVCNN2Unet(
            num_classes=2 * zdim + 2 * input_dim, sa_blocks=sa_blocks,
            fp_blocks=fp_blocks, embed_dim=0, extra_feature_channels=0,
            input_dim=input_dim, style_dim=style_dim,
            init_scale=ada_mlp_init_scale, vres_mult=vres_mult,
            ncenter_mult=ncenter_mult, dtype=dtype, dropout=dropout)

    def forward(self, x, style):
        """x (B, N, input_dim), style (B, style_dim) -> (mu, log_sigma),
        each (B, N * (zdim + input_dim))."""
        b = x.shape[0]
        d = self.input_dim
        out = self.layers(x, style=style)                  # (B, N, 2z + 2d)
        pt_mu = self.skip_weight * out[..., :d] + x
        pt_sigma = out[..., d:2 * d] - self.pts_sigma_offset
        if self.zdim == 0:
            return pt_mu.reshape(b, -1), pt_sigma.reshape(b, -1)
        mu = torch.cat([pt_mu, out[..., 2 * d:-self.zdim]], dim=-1)
        sigma = torch.cat([pt_sigma, out[..., -self.zdim:]], dim=-1)
        return mu.reshape(b, -1), sigma.reshape(b, -1)


class LatentPointDecPVC(nn.Module):
    """AdaGN U-Net over the latent points -> (B, N, point_dim).

    `context` is the flat latent (B, N*(latent_dim + point_dim)); the first
    point_dim channels of each point are the latent coordinates, used as
    the residual skip."""

    def __init__(self, point_dim: int, context_dim: int,
                 num_points: int = 2048, style_dim: int = 128,
                 skip_weight: float = 0.1, ada_mlp_init_scale: float = 1.0,
                 vres_mult: float = 1.0, ncenter_mult: float = 1.0,
                 sa_blocks=LATENT_PTS_SA_BLOCKS,
                 fp_blocks=LATENT_PTS_FP_BLOCKS,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.1):
        super().__init__()
        self.point_dim = point_dim
        self.context_dim = context_dim
        self.num_points = num_points
        self.skip_weight = skip_weight
        self.layers = PVCNN2Unet(
            num_classes=point_dim, sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            embed_dim=0, extra_feature_channels=context_dim,
            input_dim=point_dim, style_dim=style_dim,
            init_scale=ada_mlp_init_scale, vres_mult=vres_mult,
            ncenter_mult=ncenter_mult, dtype=dtype, dropout=dropout)

    def forward(self, context, style):
        b = context.shape[0]
        context = context.reshape(b, self.num_points,
                                  self.context_dim + self.point_dim)
        x = context[..., :self.point_dim]
        out = self.layers(context, style=style)
        return out * self.skip_weight + x
