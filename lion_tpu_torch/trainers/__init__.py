"""Training (port of lion_tpu/trainers): the stage-1 VAE step and the
stage-2 two-prior step with their optimizer, schedule and EMA, and the
trainers a config names by its trainer.type (`get_trainer`): the stage-1
`hvae_trainer.Trainer`, the stage-2 `train_2prior.Trainer` and
`train_prior.Trainer`, and the interpolation trainers of
`interpolate.py`; beside LION, DiT-3D's step (`DiT3DTrainStep`) and its
trainer (`dit3d_trainer.Trainer`)."""
import importlib

from .optim import EMA, Optimizer, warmup_cosine_schedule
from .steps import (DiT3DTrainStep, PriorTrainStep, VAETrainStep,
                    default_lr_schedule, default_vae_lr_schedule,
                    dit3d_lr_schedule, kl_weight_schedule,
                    make_prior_train_step, make_vae_train_step, prior_loss)

# the reference's cfg.trainer.type strings (train_dist.py:30) -> (module,
# class) of the port
TRAINERS = {
    "trainers.hvae_trainer": ("hvae_trainer", "Trainer"),
    "trainers.train_2prior": ("train_2prior", "Trainer"),
    "trainers.train_prior": ("train_prior", "Trainer"),
    "trainers.interpolate_latent": ("interpolate",
                                    "InterpolateLatentTrainer"),
    "trainers.encode_interp_interp": ("interpolate", "EncodeInterpTrainer"),
    # DiT-3D (config.default.DIT3D_TRAINER)
    "trainers.dit3d_trainer": ("dit3d_trainer", "Trainer"),
}


def get_trainer(trainer_type: str):
    """The trainer class of a cfg.trainer.type; KeyError for any other
    name."""
    if trainer_type not in TRAINERS:
        raise KeyError(f"unknown trainer type: {trainer_type} (known: "
                       f"{sorted(TRAINERS)})")
    module, name = TRAINERS[trainer_type]
    return getattr(importlib.import_module(f".{module}", __name__), name)


__all__ = ["EMA", "Optimizer", "warmup_cosine_schedule", "DiT3DTrainStep",
           "PriorTrainStep", "VAETrainStep", "default_lr_schedule",
           "default_vae_lr_schedule", "dit3d_lr_schedule",
           "kl_weight_schedule", "make_prior_train_step", "make_vae_train_step", "prior_loss",
           "TRAINERS", "get_trainer"]
