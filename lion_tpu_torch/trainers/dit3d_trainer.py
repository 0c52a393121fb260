"""The DiT-3D trainer (DiT-3D's `train.py`, after PVD's
`train_generation.py`):

    python -m lion_tpu_torch.train_dist trainer.type trainers.dit3d_trainer
        data.cates chair [key value ...]

loads the ShapeNet15k split of cfg.data as the LION trainers do, builds a
`models.dit3d.DiT3D` from cfg.dit3d with DiT's initializer from
trainer.seed, and trains it with `DiT3DTrainStep` (Adam at
trainer.opt.lr, decayed by trainer.opt.step_decay each epoch); under
data.cond_on_cat the step reads each batch's `cate_idx` as the label.
Checkpoints are `.npz` files in the layout of the LION trainers
(`ckpt.io`): the parameters, Adam's state and the EMA (under ddpm.ema).
`sample` draws clouds from the EMA where there is one: DDIM over
`ddim_step` steps, or the T-step ancestral chain.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from ..ckpt.io import (adam_state_from_tree, adam_state_tree,
                       load_tensors_tree, tensors_tree)
from ..models.registry import build_dit3d
from ..parallel.dist import fold_seed
from .base import BaseTrainer
from .steps import DiT3DTrainStep, dit3d_lr_schedule


class Trainer(BaseTrainer):
    def __init__(self, cfg, args, device="cuda"):
        super().__init__(cfg, args, device)
        self.build_data()
        self.build_model()

    def build_model(self):
        cfg = self.cfg
        self.model = build_dit3d(cfg, self.device).init_params(
            torch.Generator().manual_seed(cfg.trainer.seed))
        steps_per_epoch = max(len(self.train_loader), 1) \
            if self.train_loader else 1
        self.step_fn = DiT3DTrainStep(
            self.model, dit3d_lr_schedule(cfg, steps_per_epoch))
        self.param_names = [n for n, _ in self.model.named_parameters()]
        self.generator = torch.Generator(device=self.device).manual_seed(
            fold_seed(cfg.trainer.seed, 7))

    def labels(self, batch) -> Optional[torch.Tensor]:
        """The batch's class labels on the device under data.cond_on_cat,
        else None (the one class)."""
        if not self.cfg.data.cond_on_cat:
            return None
        return torch.as_tensor(np.asarray(batch["cate_idx"]),
                               dtype=torch.long, device=self.device)

    def train_iter(self, batch, step: int) -> Dict[str, float]:
        x = self.put_batch(batch["tr_points"])
        metrics = self.step_fn(x, self.generator,
                               class_label=self.labels(batch))
        return {k: float(v) for k, v in metrics.items()}

    def vis_sample(self, step: int):
        """The sample grid: min(num_val_samples, 8) clouds, DDIM over
        viz.vis_sample_ddim_step steps (the ancestral chain at 0), from a
        generator seeded `step`."""
        n = min(self.cfg.num_val_samples, 8)
        gen = torch.Generator(device=self.device).manual_seed(step)
        self.add_sample_grid(self.sample(
            n, generator=gen, ddim_step=self.cfg.viz.vis_sample_ddim_step),
            step)

    @torch.no_grad()
    def sample(self, num_samples: int = 16, generator=None,
               ddim_step: Optional[int] = None) -> torch.Tensor:
        """(num_samples, N, 3) clouds from the EMA parameters when there
        are some; under data.cond_on_cat with the labels arange(n) %
        data.nclass."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        labels = torch.arange(num_samples, device=self.device) \
            % self.cfg.data.nclass if self.cfg.data.cond_on_cat else None
        ema = self.step_fn.ema
        with ema.swapped() if ema is not None else contextlib.nullcontext():
            return self.model.sample(num_samples, gen, ddim_step, labels)

    def state_trees(self):
        names, step = self.param_names, self.step_fn
        mu, nu = step.optimizer.moments()
        trees = {"model": tensors_tree(names, step.params),
                 "opt": adam_state_tree(step.optimizer.count, mu, nu, names)}
        if step.ema is not None:
            trees["ema"] = tensors_tree(names, step.ema.shadow)
        return trees

    def load_state_trees(self, trees, metadata):
        names, step = self.param_names, self.step_fn
        load_tensors_tree(names, step.params, trees["model"])
        if "opt" in trees:
            step.optimizer.load_state(*adam_state_from_tree(trees["opt"],
                                                            names))
        if "ema" in trees and step.ema is not None:
            load_tensors_tree(names, step.ema.shadow, trees["ema"])
        step.optimizer.count = int(metadata.get("step", 0))
