"""Diffusion priors (port of lion_tpu/models/priors.py).

  - GlobalPrior: the 'se_drop' ResNet of 1x1 blocks (models/score_sde/
    resnet.py PriorSEDrop), dense layers over the flat style latent.
  - LocalPrior: the AdaGN PVCNN2 U-Net over the latent points, conditioned
    on the global sample through AdaGN style input.

Mixed prediction's `mixing_logit` is a parameter of each prior; the sampler
applies it (diffusion.discrete.get_mixed_prediction).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config.view import as_view
from ..nn.common import TDense, require_fp32, timestep_embedding
from ..nn.unet import PVCNN2Unet

# local prior U-Net specs (latent_points_ada_localprior.py:17-28); the third
# SA stage ends at 128 channels (the VAE's ends at 256)
LOCAL_PRIOR_SA_BLOCKS = (
    ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
    ((64, 3, 16), (256, 0.2, 32, (64, 128))),
    ((128, 3, 8), (64, 0.4, 32, (128, 128))),
    (None, (16, 0.8, 32, (128, 128, 128))),
)
LOCAL_PRIOR_FP_BLOCKS = (
    ((128, 128), (128, 3, 8)),
    ((128, 128), (128, 3, 8)),
    ((128, 128), (128, 2, 16)),
    ((128, 128, 64), (64, 2, 32)),
)


def _mixing_logit(n: int, init: float) -> nn.Parameter:
    """The mixed-prediction logit, filled with its init value (no draw)."""
    return nn.Parameter(torch.full((n,), float(init)))


class ResBlockSEDrop(nn.Module):
    """x + t -> dense -> relu -> (dropout) -> dense -> relu -> SE -> + x."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = TDense(dim, dim)
        self.conv2 = TDense(dim, dim)
        self.se_fc1 = TDense(dim // 8, dim, use_bias=False)
        self.se_fc2 = TDense(dim, dim // 8, use_bias=False)

    def forward(self, x, t):
        h = torch.relu(self.conv1(x + t))
        h = torch.relu(self.conv2(h))
        g = self.se_fc2(torch.relu(self.se_fc1(h)))
        return x + h * torch.sigmoid(g)


class GlobalPrior(nn.Module):
    """resnet.py PriorSEDrop over the flat style latent (positional time
    embedding, 'se_drop' blocks)."""

    def __init__(self, num_input_channels: int, nf: int = 2048,
                 num_blocks: int = 8, embedding_dim: int = 128,
                 embedding_type: str = "positional",
                 embedding_scale: float = 1.0, block_type: str = "se_drop",
                 mixed_prediction: bool = False,
                 mixing_logit_init: float = -6.0):
        super().__init__()
        if embedding_type != "positional" or block_type != "se_drop":
            raise NotImplementedError(
                f"GlobalPrior: {embedding_type}/{block_type} not ported "
                "(positional/se_drop only)")
        self.embedding_dim = embedding_dim
        self.embedding_scale = embedding_scale
        # two stacked dense layers, no nonlinearity between
        self.temb0 = TDense(embedding_dim * 4, embedding_dim)
        self.temb1 = TDense(nf, embedding_dim * 4)
        self.mixing_logit = _mixing_logit(num_input_channels,
                                          mixing_logit_init) \
            if mixed_prediction else None
        self.input_layer = TDense(nf, num_input_channels)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResBlockSEDrop(nf))
        self.output_layer = TDense(num_input_channels, nf)

    def forward(self, x, t):
        """x (B, C) or (B, C, 1, 1); t (B,) in [1, T] -> eps, x's shape."""
        in_shape = x.shape
        b = x.shape[0]
        x = x.reshape(b, -1)
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=x.device).reshape(-1).expand(b)
        temb = timestep_embedding(t, self.embedding_dim, self.embedding_scale)
        temb = self.temb1(self.temb0(temb))
        h = self.input_layer(x)
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i}")(h, temb)
        return self.output_layer(h).reshape(in_shape)


class LocalPrior(nn.Module):
    """latent_points_ada_localprior.py PVCNN2Prior: the U-Net over the
    latent points, conditioned on the global style sample."""

    def __init__(self, cfg):
        super().__init__()
        cfg = as_view(cfg)
        require_fp32(cfg)
        if cfg.data.cond_on_cat or cfg.clipforge.enable:
            raise NotImplementedError("class / CLIP conditioning not ported")
        self.latent_dim = cfg.shapelatent.latent_dim
        self.input_dim = cfg.ddpm.input_dim
        self.num_points = cfg.data.tr_max_sample_points
        num_classes = self.latent_dim + self.input_dim
        self.num_classes = num_classes
        self.mixing_logit = _mixing_logit(self.num_points * num_classes,
                                          cfg.sde.mixing_logit_init) \
            if cfg.sde.mixed_prediction else None
        from .vae import spec_overrides
        sa_blocks, fp_blocks = LOCAL_PRIOR_SA_BLOCKS, LOCAL_PRIOR_FP_BLOCKS
        if "tpu" in cfg and (list(cfg.tpu.sa_blocks)
                             or list(cfg.tpu.fp_blocks)):
            sa_blocks, fp_blocks = spec_overrides(cfg)
        self.unet = PVCNN2Unet(
            num_classes=num_classes, sa_blocks=sa_blocks,
            fp_blocks=fp_blocks, embed_dim=cfg.ddpm.time_dim,
            extra_feature_channels=self.latent_dim, input_dim=self.input_dim,
            time_emb_scales=cfg.sde.embedding_scale,
            style_dim=cfg.latent_pts.style_dim,
            init_scale=cfg.latent_pts.ada_mlp_init_scale,
            vres_mult=cfg.tpu.vres_mult if "tpu" in cfg else 1.0,
            ncenter_mult=cfg.tpu.ncenter_mult if "tpu" in cfg else 1.0)

    def forward(self, x, t, condition_input):
        """x (B, N*C) or (B, N, C), t (B,), condition_input (B, style) ->
        eps prediction of x's shape."""
        in_shape = x.shape
        b = x.shape[0]
        if x[0].numel() != self.num_points * self.num_classes:
            raise ValueError(f"LocalPrior: input {tuple(in_shape)}")
        x = x.reshape(b, self.num_points, self.num_classes)
        out = self.unet(x, t=t, style=condition_input.reshape(b, -1))
        return out.reshape(in_shape)
