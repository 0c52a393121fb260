"""Training (port of lion_tpu/trainers): the two-prior step and its
optimizer, schedule and EMA."""
from .optim import EMA, Optimizer, warmup_cosine_schedule
from .steps import (PriorTrainStep, default_lr_schedule,
                    make_prior_train_step, prior_loss)

__all__ = ["EMA", "Optimizer", "warmup_cosine_schedule", "PriorTrainStep",
           "default_lr_schedule", "make_prior_train_step", "prior_loss"]
