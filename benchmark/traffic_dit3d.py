"""DiT-3D's traffic kind (`benchmark/families/dit3d.py`):

- `train_dit`: closed-loop calls of `lion_tpu_torch`'s DiT-3D training
  step (`DiT3DTrainStep`: the DiT's forward on x_t, PVD's noise-prediction
  loss, the backward, Adam) on batches taken in turn from a seeded pool of
  `pool_batches` batches of ellipsoid clouds on the card, with one step in
  flight, as `traffic.TrainTraffic` drives LION's steps. Step k's draws (t
  uniform in 0..T-1, the noise, the label dropout) are made on the card
  from the run's seed and k, and handed to the step, so the check replays
  them as they were. Set-up drives the step object through its first
  `check_steps` steps and records what the check needs.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

# the program's model, imported with the family: a tree of the program
# without DiT-3D fails here, at once, naming it
from lion_tpu_torch.models.dit3d import DiT3D

from .traffic import (Traffic, TrainTraffic, ellipsoid_clouds, sub_seed,
                      sync)


def step_draws(seed: int, k: int, batch: int, points: int, steps: int,
               drop_prob: float, device) -> Dict[str, torch.Tensor]:
    """Step k's draws from the run's seed: t (B,) uniform in 0..steps-1,
    noise (B, points, 3), drop (B,) bool with probability drop_prob."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 6, k))
    t = torch.randint(0, steps, (batch,), generator=gen, device=device)
    noise = torch.randn(batch, points, 3, generator=gen, device=device)
    drop = torch.rand(batch, generator=gen, device=device) < drop_prob
    return {"t": t, "noise": noise, "drop": drop}


class DiTTrainTraffic(Traffic):
    def setup(self):
        from lion_tpu_torch.trainers import DiT3DTrainStep
        mix, dev = self.mix, self.device
        self.batch = mix["batch"]
        self.points = self.cfg["data"]["tr_max_sample_points"]
        self.pool = ellipsoid_clouds(mix["pool_batches"] * self.batch,
                                     self.points, sub_seed(self.seed, 3),
                                     dev)
        self.model = DiT3D(self.port_cfg, device=dev)
        self.model.load_state_dict(self.state, strict=True)
        # the window lies inside the first epoch: trainer.opt.lr, before
        # any per-epoch decay
        lr = float(self.cfg["trainer"]["opt"]["lr"])
        self.step = DiT3DTrainStep(self.model, lambda step: lr)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.mark("model")
        self.k = 0
        self._first_steps()

    def batch_of(self, k: int):
        """Step k's clouds and draws."""
        j = k % self.mix["pool_batches"]
        x = self.pool[j * self.batch:(j + 1) * self.batch]
        m = self.cfg["dit3d"]
        return x, step_draws(self.seed, k, self.batch, self.points,
                             int(self.cfg["ddpm"]["num_steps"]),
                             float(m["class_dropout_prob"]), self.device)

    def _call(self):
        x, draws = self.batch_of(self.k)
        self.k += 1
        return self.step(x, **draws)

    @torch.no_grad()
    def _first_steps(self):
        """The first `check_steps` steps through the window's own call:
        each step's loss, each parameter's gradient norm as Adam's first
        moment holds it after step 1, and each parameter's change norm
        after the last."""
        n = self.mix["check_steps"]
        params = self.step.params
        start = [p.detach().clone() for p in params]
        beta1 = self.step.optimizer.opt.param_groups[0]["betas"][0]
        losses = []
        for s in range(n):
            with torch.enable_grad():
                losses.append(self._call()["loss"])
            if s == 0:
                mu, _ = self.step.optimizer.moments()
                grad_norms = torch.stack([m.norm() / (1.0 - beta1)
                                          for m in mu])
        sync(self.device)
        change = torch.stack([(p.detach() - p0).norm()
                              for p, p0 in zip(params, start)])
        del start
        self.readings = {
            "losses": [float(v) for v in losses],
            "grad_norms": grad_norms.tolist(), "change": change.tolist(),
            "names": self.names,
            "batches": [self.batch_of(s) for s in range(n)]}

    # the loop, the profiled units and the failures of LION's training
    # kinds, which read only `_call`, `batch` and `device`
    window = TrainTraffic.window
    traced = TrainTraffic.traced
    failed = TrainTraffic.failed

    def layer_windows(self) -> Dict[str, float]:
        """Host-clock ms of the step's forward alone (the loss in train
        mode, its graph dropped), synced, over `layer_calls` calls on the
        next batches and draws."""
        reps = self.mix["layer_calls"]

        def fwd(r):
            x, draws = self.batch_of(self.k + r)
            with self.step.precision():
                return self.step.loss(x, **draws)

        fwd(0)
        sync(self.device)
        t = time.perf_counter()
        for r in range(reps):
            fwd(r + 1)
        sync(self.device)
        return {"forward_ms": (time.perf_counter() - t) / reps * 1e3}

    def release(self, keep=None):
        readings = self.readings
        self.step = self.model = self.pool = None
        self.losses = []
        return readings


KINDS = {"train_dit": DiTTrainTraffic}
