"""The stage-1 VAE trainer (port of lion_tpu/trainers/hvae_trainer.py).

    Trainer(cfg, args, device="cuda").train_epochs()

loads the ShapeNet15k split of cfg.data (under `args.data_root` or
cfg.data.data_dir), builds the VAE with random weights from
trainer.seed, and trains it with `make_vae_train_step` on the
warmup-cosine schedule of trainer.opt (lr, lr_min, vae_lr_warmup_epochs)
and the KL anneal over the run's steps; checkpoints go to
`<save_dir>/checkpoints/*.npz` in the JAX package's layout (ckpt/io.py),
so either package resumes the other's. Every `viz.viz_freq` steps the
trainer draws the reconstruction and sample grids (`vis_recont`,
`vis_sample`) into `<save_dir>/images/`; they need matplotlib, which the
trainer checks when it is built.
Under tpu.bf16 (or sde.autocast_train) the VAE's U-Nets compute in bf16;
the parameters, Adam, the EMA and the checkpoints stay float32. Under
data.cond_on_cat the decoder is class-conditional: the step, `eval_nll`
and `vis_recont` read each batch's `cate_idx`, and `sample` decodes the
labels arange(n) % data.nclass (lion_tpu/trainers/hvae_trainer.py:47-68;
its eval and sampling take no label).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from ..ckpt.io import (adam_state_from_tree, adam_state_tree,
                       load_tensors_tree, tensors_tree)
from ..eval.eval_helper import compute_nll_metric, normalize_point_clouds
from ..models.vae import VAE
from ..nn.common import init_weights
from ..parallel.dist import fold_seed
from ..utils.vis import visualize_point_clouds_3d
from .base import BaseTrainer
from .steps import default_vae_lr_schedule, make_vae_train_step


class Trainer(BaseTrainer):
    def __init__(self, cfg, args, device="cuda"):
        super().__init__(cfg, args, device)
        self.build_data()
        self.build_model()

    def build_model(self):
        cfg = self.cfg
        with self.device:
            self.vae = VAE(cfg)
        init_weights(self.vae, torch.Generator().manual_seed(cfg.trainer.seed))
        steps_per_epoch = max(len(self.train_loader), 1) \
            if self.train_loader else 1
        self.num_total_iter = steps_per_epoch * cfg.trainer.epochs
        self.step_fn = make_vae_train_step(
            self.vae, default_vae_lr_schedule(cfg, steps_per_epoch),
            self.num_total_iter, self.device)
        self.param_names = [n for n, _ in self.vae.named_parameters()]
        self.generator = torch.Generator(device=self.device).manual_seed(
            fold_seed(cfg.trainer.seed, 7))

    def labels(self, batch, n: int = None):
        """The batch's class labels (its first `n`) on the device under
        data.cond_on_cat, else None."""
        if not self.cfg.data.cond_on_cat:
            return None
        return torch.as_tensor(np.asarray(batch["cate_idx"])[:n],
                               dtype=torch.long, device=self.device)

    def train_iter(self, batch, step: int) -> Dict[str, float]:
        x = self.put_batch(batch["tr_points"])
        metrics = self.step_fn(x, self.generator,
                               class_label=self.labels(batch))
        return {k: float(v) for k, v in metrics.items()}

    @torch.no_grad()
    def eval_nll(self, num_batches: int = 0, generator=None):
        """Reconstruction CD / EMD over the test split, in eval mode, from
        the trained (not the EMA) parameters (lion_tpu/trainers/
        hvae_trainer.py:86-106); the EMD of each pair on K12."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        self.vae.eval()
        gens, refs = [], []
        for bi, batch in enumerate(self.test_loader or []):
            if num_batches and bi >= num_batches:
                break
            x = self.put_batch(batch["tr_points"])
            gens.append(self.vae.recont(
                x, generator=gen, class_label=self.labels(batch))[
                    "x_0_pred"].cpu())
            refs.append(x.cpu())
        if not gens:
            return {}
        results = compute_nll_metric(torch.cat(gens).numpy(),
                                     torch.cat(refs).numpy(),
                                     device=self.device)
        for k, v in results.items():
            if np.ndim(v) == 0:
                self.writer.add_scalar(f"eval/nll_{k}", float(v), self.step)
        return results

    def run_eval(self):
        """The reconstruction eval; its CD score for the best-checkpoint
        tracking."""
        results = self.eval_nll(num_batches=2)
        for k, v in results.items():
            if "CD" in k and np.ndim(v) == 0:
                return float(v)
        return None

    @torch.no_grad()
    def vis_recont(self, batch, step: int):
        """The reconstruction grid: the batch's first 4 clouds and their
        reconstructions in eval mode from the trained parameters (a
        generator seeded `step`), normalized, as `vis/recont`
        (lion_tpu/trainers/hvae_trainer.py:121-136)."""
        x = self.put_batch(np.asarray(batch["tr_points"], np.float32)[:4])
        self.vae.eval()
        gen = torch.Generator(device=self.device).manual_seed(step)
        rec = self.vae.recont(x, generator=gen,
                              class_label=self.labels(batch, 4))
        rec = rec["final_pred"]
        inp = x[:, :, :3].cpu().numpy()
        rec = rec[:, :, :3].float().cpu().numpy()
        clouds = normalize_point_clouds(np.concatenate([inp, rec], axis=0))
        titles = [f"inp-{i}" for i in range(len(inp))] + \
                 [f"rec-{i}" for i in range(len(rec))]
        img = visualize_point_clouds_3d(list(clouds), titles)
        self.writer.add_image("vis/recont", img, step)

    def vis_sample(self, step: int):
        """The sample grid: min(num_val_samples, 8) clouds decoded from
        fresh latents (a generator seeded `step`), normalized, as
        `vis/sample` (lion_tpu/trainers/hvae_trainer.py:138-148)."""
        n = min(self.cfg.num_val_samples, 8)
        gen = torch.Generator(device=self.device).manual_seed(step)
        self.add_sample_grid(self.sample(n, generator=gen), step)

    @torch.no_grad()
    def sample(self, num_samples: int = 16, generator=None) -> torch.Tensor:
        """Decode fresh latents in eval mode, from the EMA parameters when
        there are some -> (num_samples, N, input_dim); under cond_on_cat
        with the labels arange(num_samples) % data.nclass."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        vae, ema = self.vae, self.step_fn.ema
        vae.eval()
        z_global = torch.randn((num_samples, vae.style_dim), generator=gen,
                               device=self.device)
        z_local = torch.randn(
            (num_samples, vae.num_points * (vae.latent_dim + vae.input_dim)),
            generator=gen, device=self.device)
        labels = torch.arange(num_samples, device=self.device) \
            % self.cfg.data.nclass if self.cfg.data.cond_on_cat else None
        with ema.swapped() if ema is not None else contextlib.nullcontext():
            return vae.sample(num_samples, [z_global, z_local],
                              class_label=labels)

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
