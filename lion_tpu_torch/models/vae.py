"""Hierarchical VAE: encode, reconstruct, the ELBO and decode (port of
`VAE.encode`, `recont`, `get_loss` and `sample`,
lion_tpu/models/vae.py:150-275).

The style encoder (`style_encoder.`), the latent-points encoder
(`encoder.`) and the decoder (`decoder.`) sit under the names of the JAX
tree, so the whole JAX VAE loads with a flatten (ckpt/from_jax.py).
`encode` is what the two-prior training step runs, frozen and in eval mode;
`get_loss` is the stage-1 objective that `trainers.make_vae_train_step`
trains, in train mode (dropout, the PVConv modular flow on K10). The
module's mode decides the flow, where the JAX methods take `train=`.
Under `data.cond_on_cat` the decoder is class-conditional
(lion_tpu/models/vae.py:63-79, 130-146): `class_embedding`, a bias-free
dense layer of width `tpu.cls_emb_dim` over the one-hot label, and the
decoder's style concat([z_global, cls_emb]); the encoders take no class
input (that input is dead in the reference, vae_adain.py:66). The shapes
of x are checked where it is encoded (utils/checker.py). Under `tpu.bf16`
the encoder's and the decoder's U-Nets compute in bf16 (`compute_dtype`),
in training too; the style encoder stays float32, as the JAX VAE builds
it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config.view import as_view
from ..nn.common import TDense, compute_dtype
from ..utils.checker import CHECK3D, CHECKDIM
from ..utils.losses import loss_fn
from .distributions import Normal
from .encoders import (LATENT_PTS_FP_BLOCKS, LATENT_PTS_SA_BLOCKS,
                       LatentPointDecPVC, PointNetPlusEncoder, PointTransPVC)


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
        self.cfg = cfg
        cfg = as_view(cfg)
        for name, want in (
                (cfg.latent_pts.style_encoder, "PointNetPlusEncoder"),
                (cfg.shapelatent.encoder_type, "PointTransPVC"),
                (cfg.shapelatent.decoder_type, "LatentPointDecPVC")):
            if not name.endswith(want):
                raise NotImplementedError(name)
        if cfg.latent_pts.style_mlp != "":
            raise NotImplementedError(
                "style_mlp variants not implemented; released configs use ''")
        self.input_dim = cfg.ddpm.input_dim
        self.latent_dim = cfg.shapelatent.latent_dim
        self.num_points = cfg.data.tr_max_sample_points
        self.style_dim = cfg.latent_pts.style_dim
        self.log_sigma_offset = cfg.shapelatent.log_sigma_offset
        self.kl_weight = cfg.shapelatent.kl_weight
        self.loss_type = cfg.ddpm.loss_type
        self.loss_weight_emd = cfg.ddpm.loss_weight_emd
        self.weight_recont = cfg.weight_recont
        self.weight_kl = (cfg.latent_pts.weight_kl_glb,
                          cfg.latent_pts.weight_kl_pt,
                          cfg.latent_pts.weight_kl_feat)
        vres_mult = cfg.tpu.vres_mult if "tpu" in cfg else 1.0
        ncenter_mult = cfg.tpu.ncenter_mult if "tpu" in cfg else 1.0
        sa_blocks, fp_blocks = spec_overrides(cfg)
        self.cond_on_cat = bool(cfg.data.cond_on_cat)
        dec_style_dim = self.style_dim
        if self.cond_on_cat:
            self.nclass = int(cfg.data.nclass)
            self.cls_emb_dim = int(cfg.tpu.cls_emb_dim) \
                if "cls_emb_dim" in cfg.tpu else 64
            self.class_embedding = TDense(self.cls_emb_dim, self.nclass,
                                          use_bias=False)
            dec_style_dim += self.cls_emb_dim
        self.style_encoder = PointNetPlusEncoder(
            zdim=self.style_dim, input_dim=self.input_dim,
            dropout=cfg.ddpm.dropout, vres_mult=vres_mult,
            ncenter_mult=ncenter_mult)
        self.encoder = PointTransPVC(
            zdim=self.latent_dim, input_dim=self.input_dim,
            style_dim=self.style_dim, skip_weight=cfg.latent_pts.skip_weight,
            pts_sigma_offset=cfg.latent_pts.pts_sigma_offset,
            dropout=cfg.ddpm.dropout,
            ada_mlp_init_scale=cfg.latent_pts.ada_mlp_init_scale,
            vres_mult=vres_mult, ncenter_mult=ncenter_mult,
            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            dtype=compute_dtype(cfg))
        self.decoder = LatentPointDecPVC(
            point_dim=self.input_dim, context_dim=self.latent_dim,
            num_points=self.num_points, style_dim=dec_style_dim,
            skip_weight=cfg.latent_pts.skip_weight,
            dropout=cfg.ddpm.dropout,
            ada_mlp_init_scale=cfg.latent_pts.ada_mlp_init_scale,
            vres_mult=vres_mult, ncenter_mult=ncenter_mult,
            sa_blocks=sa_blocks, fp_blocks=fp_blocks,
            dtype=compute_dtype(cfg))

    def embed_class(self, class_label) -> torch.Tensor:
        """(B,) int labels or (B, nclass) one-hot rows -> (B, cls_emb_dim):
        one-hot @ W, the same for both forms
        (lion_tpu/models/vae.py:130-139)."""
        if not self.cond_on_cat:
            raise ValueError("embed_class needs data.cond_on_cat")
        w = self.class_embedding.kernel
        label = torch.as_tensor(class_label, device=w.device)
        if label.ndim == 1:
            label = torch.nn.functional.one_hot(label.long(), self.nclass)
        return self.class_embedding(label.float())

    def dec_style(self, z_global, class_label=None) -> torch.Tensor:
        """The decoder's style: concat([z_global, cls_emb]) under
        cond_on_cat (vae_adain.py:167), else the raw z_global
        (vae_adain.py:328-331)."""
        if not self.cond_on_cat:
            return z_global
        if class_label is None:
            raise ValueError("data.cond_on_cat: the decoder needs "
                             "class_label")
        return torch.cat([z_global, self.embed_class(class_label)], dim=1)

    def encode(self, x, generator=None, rho=None):
        """x (B, N, input_dim) -> (all_eps (B, style + N*(latent + input)),
        all_log_q, latent_list), as the JAX `encode`: the style posterior is
        sampled first and conditions the latent-points encoder. The two
        standard normals come from `generator` unless given as
        `rho = (rho_global, rho_local)`."""
        CHECK3D(x)
        CHECKDIM(x, 2, self.input_dim)
        rho_g, rho_l = rho if rho is not None else (None, None)
        dist_global = Normal(*self.style_encoder(x))
        z_global, _ = dist_global.sample(generator, rho_g)
        mu, sigma = self.encoder(x, z_global)
        dist_local = Normal(mu, sigma - self.log_sigma_offset)
        z_local, _ = dist_local.sample(generator, rho_l)
        all_eps = torch.cat([z_global.reshape(x.shape[0], -1),
                             z_local.reshape(x.shape[0], -1)], dim=1)
        all_log_q = [dist_global.log_p(z_global), dist_local.log_p(z_local)]
        latent_list = [(z_global, dist_global.mu, dist_global.log_sigma),
                       (z_local, dist_local.mu, dist_local.log_sigma)]
        return all_eps, all_log_q, latent_list

    def recont(self, x, target=None, generator=None, rho=None,
               class_label=None) -> dict:
        """The reconstruction pass: encode x, decode z_local under the raw
        z_global, or with the class embedding of `class_label` under
        cond_on_cat (lion_tpu/models/vae.py:173-201). Returns all_eps,
        all_log_q, latent_list, x_0_pred, x_0_target and final_pred, and
        cls_emb under cond_on_cat."""
        all_eps, all_log_q, latent_list = self.encode(x, generator, rho)
        style = self.dec_style(latent_list[0][0], class_label)
        x_0_pred = self.decoder(latent_list[1][0], style)
        out = {"all_eps": all_eps, "all_log_q": all_log_q,
               "latent_list": latent_list, "x_0_pred": x_0_pred,
               "x_0_target": x if target is None else target,
               "final_pred": x_0_pred}
        if self.cond_on_cat:
            out["cls_emb"] = style[:, self.style_dim:]
        return out

    def get_loss(self, x, kl_weight=None, noisy_input=None, generator=None,
                 rho=None, class_label=None) -> dict:
        """The ELBO with per-group weighted KL (lion_tpu/models/vae.py:
        203-253): `recont`'s outputs and loss, rec_loss, and the metrics
        print/loss_0, print/kl_glb, print/kl_pt, print/kl_feat,
        print/kl_weight, msg/kl and msg/rec. `kl_weight` is the annealed
        weight (shapelatent.kl_weight when None); `noisy_input`, when
        given, is encoded in place of x, which stays the target;
        `class_label` conditions the decoder under cond_on_cat."""
        if kl_weight is None:
            kl_weight = self.kl_weight
        b = x.shape[0]
        inputs = x if noisy_input is None else noisy_input
        output = self.recont(inputs, target=x, generator=generator, rho=rho,
                             class_label=class_label)
        loss_0 = torch.mean(loss_fn(
            output["x_0_pred"], output["x_0_target"], self.loss_type,
            self.input_dim, b, loss_weight_emd=self.loss_weight_emd))
        output["rec_loss"] = loss_0
        output["print/loss_0"] = loss_0
        w_glb, w_pt, w_feat = self.weight_kl
        (_, mu_g, ls_g), (_, mu_l, ls_l) = output["latent_list"]
        kl_style = Normal(mu_g, ls_g).kl_to_standard().reshape(b, -1).sum(-1)
        kl3 = Normal(mu_l, ls_l).kl_to_standard().reshape(
            b, -1, self.latent_dim + self.input_dim)
        kl_pt = kl3[..., :self.input_dim].sum(dim=(1, 2))
        kl_feat = kl3[..., self.input_dim:].sum(dim=(1, 2))
        output["print/kl_glb"] = kl_style.mean()
        output["print/kl_pt"] = kl_pt.mean()
        output["print/kl_feat"] = kl_feat.mean()
        kl = kl_weight * (kl_style * w_glb + kl_pt * w_pt + kl_feat * w_feat)
        loss = kl.mean() + loss_0 * self.weight_recont
        output["msg/kl"] = kl.mean()
        output["msg/rec"] = loss_0
        output["print/kl_weight"] = kl_weight
        output["loss"] = loss
        return output

    def sample(self, num_samples: int, decomposed_eps,
               class_label=None) -> torch.Tensor:
        """Decode the latents [z_global (B, style), z_local (B, N*(latent +
        point))] -> points (B, N, point_dim). The decoder is conditioned on
        the raw z_global (vae_adain.py:328-331), with the class embedding of
        `class_label` under cond_on_cat."""
        z_global = decomposed_eps[0].reshape(num_samples, self.style_dim)
        z_local = decomposed_eps[1].reshape(
            num_samples, self.num_points * (self.latent_dim + self.input_dim))
        return self.decoder(z_local, self.dec_style(z_global, class_label))
