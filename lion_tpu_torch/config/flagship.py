"""The flagship sampling configuration: the released airplane/chair prior
shape (config/airplane_prior_cfg.yml), fp32.

Mirrors `__graft_entry__._flagship_cfg` of the JAX package and also sets the
released global-prior width, nf = 2048 (sde.num_channels_dae; the default
tree leaves it at 256)."""
from .default import get_default_cfg


def flagship_cfg(num_points: int = 2048):
    cfg = get_default_cfg()
    cfg.data.tr_max_sample_points = num_points
    cfg.shapelatent.latent_dim = 1
    cfg.shapelatent.encoder_type = "models.latent_points_ada.PointTransPVC"
    cfg.shapelatent.decoder_type = "models.latent_points_ada.LatentPointDecPVC"
    cfg.latent_pts.ada_mlp_init_scale = 0.1
    cfg.latent_pts.skip_weight = 0.01
    cfg.shapelatent.log_sigma_offset = 6.0
    cfg.latent_pts.pvd_mse_loss = 1
    cfg.sde.num_channels_dae = 2048
    cfg.tpu.bf16 = False
    return cfg
