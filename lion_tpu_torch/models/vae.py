"""Hierarchical VAE, decode only (port of `VAE.sample`,
lion_tpu/models/vae.py:255-275).

The port holds the decoder alone: sampling decodes latents drawn by the
priors, and the encoders, `recont` and the losses are later work. Its
parameters sit under `decoder.` exactly as in the JAX tree, so the JAX
params load after dropping their encoder subtrees (ckpt/from_jax.py).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config.view import as_view
from ..nn.common import compute_dtype
from .encoders import (LATENT_PTS_FP_BLOCKS, LATENT_PTS_SA_BLOCKS,
                       LatentPointDecPVC)


def _deep_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_deep_tuple(v) for v in x)
    return x


def spec_overrides(cfg):
    """cfg.tpu.{sa,fp}_blocks overrides (empty -> reference specs)."""
    sa, fp = LATENT_PTS_SA_BLOCKS, LATENT_PTS_FP_BLOCKS
    if "tpu" in cfg:
        raw_sa = list(cfg.tpu.sa_blocks) if "sa_blocks" in cfg.tpu else []
        raw_fp = list(cfg.tpu.fp_blocks) if "fp_blocks" in cfg.tpu else []
        if raw_sa:
            sa = _deep_tuple(raw_sa)
        if raw_fp:
            fp = _deep_tuple(raw_fp)
    return sa, fp


class VAE(nn.Module):
    """cfg-driven hierarchical VAE; `cfg` is the full config tree."""

    def __init__(self, cfg):
        super().__init__()
        cfg = as_view(cfg)
        if cfg.data.cond_on_cat:
            raise NotImplementedError("class-conditional decoding not ported")
        if not cfg.shapelatent.decoder_type.endswith("LatentPointDecPVC"):
            raise NotImplementedError(cfg.shapelatent.decoder_type)
        self.input_dim = cfg.ddpm.input_dim
        self.latent_dim = cfg.shapelatent.latent_dim
        self.num_points = cfg.data.tr_max_sample_points
        self.style_dim = cfg.latent_pts.style_dim
        sa_blocks, fp_blocks = spec_overrides(cfg)
        self.decoder = LatentPointDecPVC(
            point_dim=self.input_dim, context_dim=self.latent_dim,
            num_points=self.num_points, style_dim=self.style_dim,
            skip_weight=cfg.latent_pts.skip_weight,
            ada_mlp_init_scale=cfg.latent_pts.ada_mlp_init_scale,
            vres_mult=cfg.tpu.vres_mult if "tpu" in cfg else 1.0,
            ncenter_mult=cfg.tpu.ncenter_mult if "tpu" in cfg else 1.0,
            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            dtype=compute_dtype(cfg))

    def sample(self, num_samples: int, decomposed_eps) -> torch.Tensor:
        """Decode the latents [z_global (B, style), z_local (B, N*(latent +
        point))] -> points (B, N, point_dim). The decoder is conditioned on
        the raw z_global (vae_adain.py:328-331)."""
        z_global = decomposed_eps[0].reshape(num_samples, self.style_dim)
        z_local = decomposed_eps[1].reshape(
            num_samples, self.num_points * (self.latent_dim + self.input_dim))
        return self.decoder(z_local, z_global)
