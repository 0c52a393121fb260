"""Builds the priors from the config's dotted model names (port of
lion_tpu/models/registry.py, the two prior builders), and DiT-3D from
cfg.dit3d."""
from __future__ import annotations

from .priors import GlobalPrior, LocalPrior

_BLOCK_TYPE = {
    "models.score_sde.resnet.Prior": "plain",
    "models.score_sde.resnet.PriorSEDrop": "se_drop",
    "models.score_sde.resnet.PriorSEClip": "se_clip",
}


def build_global_prior(cfg) -> GlobalPrior:
    """The global (style) prior from cfg.latent_pts.style_prior + cfg.sde,
    with the CLIP mapping under cfg.clipforge.enable."""
    name = cfg.latent_pts.style_prior
    if name not in _BLOCK_TYPE:
        raise KeyError(f"Unknown global prior: {name}")
    return GlobalPrior(
        num_input_channels=cfg.latent_pts.style_dim,
        nf=cfg.sde.num_channels_dae,
        num_blocks=cfg.sde.num_cell_per_scale_dae,
        embedding_dim=cfg.sde.embedding_dim,
        embedding_type=cfg.sde.embedding_type,
        embedding_scale=cfg.sde.embedding_scale,
        dropout=cfg.sde.dropout,
        block_type=_BLOCK_TYPE[name],
        mixed_prediction=bool(cfg.sde.mixed_prediction),
        mixing_logit_init=cfg.sde.mixing_logit_init,
        clip_forge_enable=bool(cfg.clipforge.enable),
        clip_feat_dim=cfg.clipforge.feat_dim)


def build_local_prior(cfg) -> LocalPrior:
    name = cfg.sde.prior_model
    if not name.endswith("PVCNN2Prior"):
        raise KeyError(f"Unknown local prior: {name}")
    return LocalPrior(cfg)


def build_dit3d(cfg, device="cuda"):
    """DiT-3D (`models.dit3d.DiT3D`) of cfg.dit3d on `device`, its
    parameters not yet drawn (`init_params`)."""
    from .dit3d import DiT3D
    if "dit3d" not in cfg:
        raise KeyError("build_dit3d: the config has no dit3d node (build "
                       "it with get_default_cfg(dit3d=True))")
    return DiT3D(cfg, device=device)
