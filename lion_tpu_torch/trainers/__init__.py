"""Training (port of lion_tpu/trainers): the stage-1 VAE step and the
stage-2 two-prior step with their optimizer, schedule and EMA. The stage-1
trainer is `trainers.hvae_trainer.Trainer`."""
from .optim import EMA, Optimizer, warmup_cosine_schedule
from .steps import (PriorTrainStep, VAETrainStep, default_lr_schedule,
                    default_vae_lr_schedule, kl_weight_schedule,
                    make_prior_train_step, make_vae_train_step, prior_loss)

__all__ = ["EMA", "Optimizer", "warmup_cosine_schedule", "PriorTrainStep",
           "VAETrainStep", "default_lr_schedule", "default_vae_lr_schedule",
           "kl_weight_schedule", "make_prior_train_step",
           "make_vae_train_step", "prior_loss"]
