"""Diffusion priors (port of lion_tpu/models/priors.py).

  - GlobalPrior: the ResNet of 1x1 blocks (models/score_sde/resnet.py),
    dense layers over the flat style latent: the 'se_drop' blocks of
    PriorSEDrop (the released models), the 'se_clip' blocks of PriorSEClip
    (CLIP-conditioned, clipforge.enable) or the 'plain' ELU + GroupNorm
    blocks of Prior; the positional or the random-Fourier time embedding.
  - LocalPrior: the AdaGN PVCNN2 U-Net over the latent points, conditioned
    on the global sample through AdaGN style input, widened by the class
    embedding under data.cond_on_cat and mapped with CLIP features under
    clipforge.enable.

Mixed prediction's `mixing_logit` is a parameter of each prior; the sampler
applies it (diffusion.discrete.get_mixed_prediction). Both priors train in
train mode (`self.training`), with dropout: sde.dropout in the global
prior's blocks, ddpm.dropout in the local prior's U-Net.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.view import as_view
from ..nn.common import (Dropout, GNAffine, RandomFourierEmbedding, TDense,
                         compute_dtype, group_norm, timestep_embedding)
from ..nn.unet import PVCNN2Unet
from ..utils.checker import CHECKEQ

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

    def __init__(self, dim: int, dropout: float):
        super().__init__()
        self.drop = Dropout(dropout)
        self.conv1 = TDense(dim, dim)
        self.conv2 = TDense(dim, dim)
        self.se_fc1 = TDense(dim // 8, dim, use_bias=False)
        self.se_fc2 = TDense(dim, dim // 8, use_bias=False)

    def forward(self, x, t):
        h = self.drop(torch.relu(self.conv1(x + t)))
        h = torch.relu(self.conv2(h))
        g = self.se_fc2(torch.relu(self.se_fc1(h)))
        return x + h * torch.sigmoid(g)


class ResBlockSEClip(nn.Module):
    """The CLIP-conditioned block (resnet.py:29-56): t carries [temb, clip]
    on its channels; concat([x + temb, clip]) -> dense -> relu -> dense ->
    relu -> SE -> + x."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.conv1 = TDense(dim, dim * 2)
        self.conv2 = TDense(dim, dim)
        self.se_fc1 = TDense(dim // 8, dim, use_bias=False)
        self.se_fc2 = TDense(dim, dim // 8, use_bias=False)

    def forward(self, x, t):
        temb, clip_feat = t[:, :self.dim], t[:, self.dim:]
        h = torch.relu(self.conv1(torch.cat([x + temb, clip_feat], dim=-1)))
        h = torch.relu(self.conv2(h))
        g = self.se_fc2(torch.relu(self.se_fc1(h)))
        return x + h * torch.sigmoid(g)


class ResBlockPlain(nn.Module):
    """h = x + t; h + elu(GN(dense(elu(GN(dense(h)))))) with GroupNorm of
    min(dim // 4, 32) groups and eps 1e-6 (resnet.py Prior's block)."""

    def __init__(self, dim: int):
        super().__init__()
        self.groups = min(dim // 4, 32)
        self.conv1 = TDense(dim, dim)
        self.norm1 = GNAffine(dim)
        self.conv2 = TDense(dim, dim)
        self.norm2 = GNAffine(dim)

    def forward(self, x, t):
        h = x + t
        out = self.conv1(h)
        out = F.elu(group_norm(out, self.norm1.scale, self.norm1.bias,
                               self.groups, 1e-6))
        out = self.conv2(out)
        out = F.elu(group_norm(out, self.norm2.scale, self.norm2.bias,
                               self.groups, 1e-6))
        return h + out


class GlobalPrior(nn.Module):
    """resnet.py's Prior family over the flat style latent: 'se_drop'
    (PriorSEDrop), 'se_clip' (PriorSEClip) or 'plain' (Prior) blocks; the
    positional time embedding, or the random-Fourier one for any other
    `embedding_type`, as the JAX package picks it. With
    `clip_forge_enable` the CLIP features, mapped to nf wide by
    `clip_feat_mapping`, join the time embedding on its channels
    (lion_tpu/models/priors.py:148-151): the 'se_clip' blocks read them,
    the 'plain' blocks only the time embedding; the 'se_drop' blocks take
    none, and a CLIP prior of them, or 'se_clip' blocks without CLIP, is
    refused."""

    def __init__(self, num_input_channels: int, nf: int = 2048,
                 num_blocks: int = 8, embedding_dim: int = 128,
                 embedding_type: str = "positional",
                 embedding_scale: float = 1.0, dropout: float = 0.2,
                 block_type: str = "se_drop",
                 mixed_prediction: bool = False,
                 mixing_logit_init: float = -6.0,
                 clip_forge_enable: bool = False, clip_feat_dim: int = 512):
        super().__init__()
        if block_type not in ("se_drop", "se_clip", "plain"):
            raise ValueError(f"GlobalPrior: unknown block type {block_type}")
        if (block_type == "se_clip") != bool(clip_forge_enable) and \
                block_type != "plain":
            raise ValueError(
                f"GlobalPrior: the {block_type} blocks with clip_forge_enable"
                f" = {bool(clip_forge_enable)}; CLIP conditioning "
                "(clipforge.enable) needs the se_clip blocks "
                "(latent_pts.style_prior models.score_sde.resnet."
                "PriorSEClip), which need it")
        self.embedding_dim = embedding_dim
        self.embedding_scale = embedding_scale
        self.temb_fun = None if embedding_type == "positional" else \
            RandomFourierEmbedding(embedding_dim, embedding_scale)
        # two stacked dense layers, no nonlinearity between
        self.temb0 = TDense(embedding_dim * 4, embedding_dim)
        self.temb1 = TDense(nf, embedding_dim * 4)
        self.nf = nf
        self.clip_feat_mapping = TDense(nf, clip_feat_dim) \
            if clip_forge_enable else None
        self.mixing_logit = _mixing_logit(num_input_channels,
                                          mixing_logit_init) \
            if mixed_prediction else None
        self.input_layer = TDense(nf, num_input_channels)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            block = {"se_drop": lambda: ResBlockSEDrop(nf, dropout),
                     "se_clip": lambda: ResBlockSEClip(nf),
                     "plain": lambda: ResBlockPlain(nf)}[block_type]()
            self.add_module(f"block{i}", block)
        self.plain = block_type == "plain"
        self.output_layer = TDense(num_input_channels, nf)

    def forward(self, x, t, clip_feat=None):
        """x (B, C) or (B, C, 1, 1); t (B,) in [1, T]; `clip_feat` (B,
        clip_feat_dim) under clip_forge_enable -> eps, x's shape."""
        in_shape = x.shape
        b = x.shape[0]
        x = x.reshape(b, -1)
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=x.device).reshape(-1).expand(b)
        if self.temb_fun is None:
            temb = timestep_embedding(t, self.embedding_dim,
                                      self.embedding_scale)
        else:
            temb = self.temb_fun(t)
        temb = self.temb1(self.temb0(temb))
        if self.clip_feat_mapping is not None:
            if clip_feat is None:
                raise ValueError("clip_forge_enable: the global prior needs "
                                 "clip_feat")
            temb = torch.cat([temb, self.clip_feat_mapping(
                clip_feat.to(x.device))], dim=-1)
            if self.plain:
                temb = temb[:, :self.nf]
        h = self.input_layer(x)
        for i in range(self.num_blocks):
            h = getattr(self, f"block{i}")(h, temb)
        return self.output_layer(h).reshape(in_shape)


class LocalPrior(nn.Module):
    """latent_points_ada_localprior.py PVCNN2Prior: the U-Net over the
    latent points, conditioned on the global style sample; its condition is
    concat([z_global, cls_emb]), style + tpu.cls_emb_dim wide, under
    data.cond_on_cat (lion_tpu/models/priors.py:220-232), and the U-Net
    maps CLIP features into it under clipforge.enable."""

    def __init__(self, cfg):
        super().__init__()
        cfg = as_view(cfg)
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
            style_dim=cfg.latent_pts.style_dim + (
                int(cfg.tpu.cls_emb_dim) if cfg.data.cond_on_cat else 0),
            init_scale=cfg.latent_pts.ada_mlp_init_scale,
            clip_forge_enable=bool(cfg.clipforge.enable),
            clip_forge_dim=cfg.clipforge.feat_dim,
            vres_mult=cfg.tpu.vres_mult if "tpu" in cfg else 1.0,
            ncenter_mult=cfg.tpu.ncenter_mult if "tpu" in cfg else 1.0,
            dtype=compute_dtype(cfg), dropout=cfg.ddpm.dropout)

    def forward(self, x, t, condition_input, clip_feat=None):
        """x (B, N*C) or (B, N, C), t (B,), condition_input (B, style [+
        cls_emb_dim]), `clip_feat` (B, clipforge.feat_dim) under
        clipforge.enable -> eps prediction of x's shape."""
        in_shape = x.shape
        b = x.shape[0]
        CHECKEQ(x[0].numel(), self.num_points * self.num_classes)
        x = x.reshape(b, self.num_points, self.num_classes)
        out = self.unet(x, t=t, style=condition_input.reshape(b, -1),
                        clip_feat=clip_feat)
        return out.reshape(in_shape)
