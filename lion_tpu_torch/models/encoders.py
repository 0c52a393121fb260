"""VAE decoder (port of LatentPointDecPVC, lion_tpu/models/encoders.py).

The encoders (PointNetPlusEncoder, PointTransPVC) are not ported yet: the
sampling path only decodes.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.unet import PVCNN2Unet

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
                 dtype: Optional[torch.dtype] = None):
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
            ncenter_mult=ncenter_mult, dtype=dtype)

    def forward(self, context, style):
        b = context.shape[0]
        context = context.reshape(b, self.num_points,
                                  self.context_dim + self.point_dim)
        x = context[..., :self.point_dim]
        out = self.layers(context, style=style)
        return out * self.skip_weight + x
