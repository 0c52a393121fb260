"""Losses, the metrics writer, visualization and experiment naming (port
of lion_tpu/utils)."""
from .exp_helper import (ExpTimer, get_evalname, get_expname, get_git_hash,
                         hash_config)
from .losses import (kl_balancer, kl_balancer_coeff, kl_coeff, kl_per_group,
                     loss_fn)
from .vis import plot_points, visualize_point_clouds_3d
from .writer import AvgMeter, Writer

__all__ = ["ExpTimer", "get_evalname", "get_expname", "get_git_hash",
           "hash_config", "kl_balancer", "kl_balancer_coeff", "kl_coeff",
           "kl_per_group", "loss_fn", "plot_points",
           "visualize_point_clouds_3d", "AvgMeter", "Writer"]
