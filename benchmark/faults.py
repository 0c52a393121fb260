"""The LION family's faults, planted in the program for the check's own
tests: each is a context manager that patches the port's timed path while
it is active.

  frozen         a step that returns its state unchanged: the DDIM update
                 keeps x (sampling); Adam's update leaves the parameters
                 (training)
  unapplied      Adam's moments formed but the update left out: the
                 parameters keep their values, as at a learning rate of 0
                 (training)
  half_batch     half of the batch left out, the loss the mean over the
                 rest (training)
  altered        an answer altered where it is produced: the decoded points
                 of one shape moved (sampling)
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def frozen(kind: str):
    if kind == "sample":
        import torch
        from lion_tpu_torch.diffusion.discrete import DiffusionDiscretized

        def stuck(self, model_fn, num_samples, shape, ddim_step,
                  skip_type="uniform", kappa=1.0, generator=None,
                  device=None, mixing_logit=None, x_noisy=None):
            x = x_noisy.reshape((num_samples,) + tuple(shape))
            for t in self.ddim_tau_schedule(ddim_step, skip_type):
                model_fn(x, torch.full((num_samples,), t + 1.0,
                                       device=x.device))
            return x
        return _patched(DiffusionDiscretized, "run_ddim", stuck)
    from lion_tpu_torch.trainers.optim import Optimizer

    def no_update(self):
        self.count += 1
    return _patched(Optimizer, "step", no_update)


def unapplied(kind: str):
    from lion_tpu_torch.trainers.optim import Optimizer
    step = Optimizer.step

    def lr_zero(self):
        schedule = self.lr_schedule
        self.lr_schedule = lambda count: 0.0
        try:
            step(self)
        finally:
            self.lr_schedule = schedule
    return _patched(Optimizer, "step", lr_zero)


def half_batch(kind: str):
    from lion_tpu_torch.trainers.steps import TrainStep
    call = TrainStep.__call__

    def half(self, x, generator=None, **draws):
        b = x.shape[0] // 2
        return call(self, x[:b], generator,
                    **{k: v[:b] for k, v in draws.items()})
    return _patched(TrainStep, "__call__", half)


def altered(kind: str):
    from lion_tpu_torch.models.lion import LION
    sample = LION.sample

    def moved(self, *args, **kwargs):
        out = sample(self, *args, **kwargs)
        out["points"][0] = out["points"][0] + out["points"][0].std()
        return out
    return _patched(LION, "sample", moved)


FAULTS = {"frozen": frozen, "unapplied": unapplied,
          "half_batch": half_batch, "altered": altered}
# the faults each kind of cell can have
OF_KIND = {"sample": ("frozen", "altered"),
           "train_vae": ("frozen", "unapplied", "half_batch"),
           "train_prior": ("frozen", "unapplied", "half_batch")}
