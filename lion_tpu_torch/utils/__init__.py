"""Losses and the metrics writer (port of lion_tpu/utils)."""
from .losses import (kl_balancer, kl_balancer_coeff, kl_coeff, kl_per_group,
                     loss_fn)
from .writer import AvgMeter, Writer

__all__ = ["kl_balancer", "kl_balancer_coeff", "kl_coeff", "kl_per_group",
           "loss_fn", "AvgMeter", "Writer"]
