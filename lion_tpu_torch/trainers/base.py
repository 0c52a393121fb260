"""The base trainer (port of lion_tpu/trainers/base.py): the epoch loop
with its log, viz, save and val cadences, best-checkpoint tracking,
time-based snapshots and resume. The step itself is a `trainers.steps`
object; this class owns the host-side loop (batches, cadences, checkpoint
files).

Data parallel (one process a device inside a torch.distributed group,
parallel/dist.py): each rank reads its shard of the training split
(`num_shards` = the world size, as lion_tpu/trainers/base.py:131-135
does), `data.batch_size` rows a rank, and seeds its generators by
`fold_seed`; only rank 0 creates the experiment's directories and writes
checkpoints, snapshots, metrics.jsonl and images; every rank resumes from
the same files.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ckpt.io import (has_snapshot, load_checkpoint, load_snapshot,
                       save_checkpoint, save_snapshot)
from ..config.view import as_view
from ..data.shapenet import get_data_loaders
from ..eval.eval_helper import normalize_point_clouds
from ..models.lion import resolve_device
from ..parallel.dist import rank, world
from ..utils.vis import visualize_point_clouds_3d
from ..utils.writer import Writer


def _validate_semantic_knobs(cfg):
    """Fail loudly on config knobs whose behaviour is not implemented, so
    no key is silently ignored (lion_tpu/trainers/base.py:24-71).

    - sde.drop_inactive_var: the reference raises when it fires.
    - sde.jac_reg_coeff / kin_reg_coeff with the weighted objective: they
      need continuous diffusion and mixed prediction, where the reference
      crashes without them.
    - eval.need_denoise: dead in the reference; a warning, not an error.
    """
    if cfg.sde.mixed_prediction and cfg.sde.drop_inactive_var:
        raise NotImplementedError(
            "sde.drop_inactive_var=1: inactive-variable masking is "
            "unimplemented in the reference snapshot too "
            "(base_trainer.py:198 raises)")
    if (float(cfg.sde.jac_reg_coeff) > 0 or float(cfg.sde.kin_reg_coeff) > 0
            ) and not bool(cfg.latent_pts.pvd_mse_loss):
        if not bool(cfg.sde.ode_sample):
            raise NotImplementedError(
                "sde.jac/kin_reg_coeff > 0 needs continuous diffusion "
                "(sde.ode_sample=1): the regularizers evaluate "
                "diffusion.f(t) (utils/utils.py:1397), which the discrete "
                "DiffusionDiscretized does not define — the reference "
                "crashes identically")
        if not bool(cfg.sde.mixed_prediction):
            raise NotImplementedError(
                "sde.jac/kin_reg_coeff > 0 needs sde.mixed_prediction=1: "
                "the regularizers read dae.mixing_logit "
                "(utils/utils.py:1209), absent without mixed prediction")
    if int(cfg.eval.need_denoise):
        warnings.warn(
            "eval.need_denoise=1 is a no-op: the knob is dead in the "
            "reference snapshot (kwarg accepted at train_prior.py:44 but "
            "never consumed); sampling proceeds unchanged", stacklevel=2)


def check_vis_supported(cfg) -> None:
    """The visualizations (`viz.viz_freq` other than 0) draw with
    matplotlib: raise at build when it cannot be imported, rather than at
    the first grid, hours into a run."""
    if cfg.viz.viz_freq == 0:
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as err:
        raise ImportError(
            f"viz.viz_freq = {cfg.viz.viz_freq} draws training-time "
            f"visualizations with matplotlib, which cannot be imported "
            f"({err}); install matplotlib or set viz.viz_freq 0") from err


def map_autocast_train(cfg) -> None:
    """sde.autocast_train, the reference's mixed precision, is the bf16
    compute path: set tpu.bf16 before any model is built, as
    lion_tpu/trainers/base.py:77-84 does (bf16 keeps float32's exponent
    range, so no gradient scaler)."""
    if cfg.sde.autocast_train and not cfg.tpu.bf16:
        cfg.tpu.bf16 = True


class BaseTrainer:
    """`cfg` is the config tree, `args` carries `save_dir` and `data_root`
    (either may be None); the trainer runs on `device`, the card unless
    the caller asks for "cpu" (without CUDA the default raises). Under
    sde.autocast_train the trainer sets tpu.bf16 (`map_autocast_train`).
    USE_TFB=1 adds the writer's TensorBoard sink."""

    def __init__(self, cfg, args, device="cuda"):
        _validate_semantic_knobs(cfg)
        check_vis_supported(cfg)
        map_autocast_train(cfg)
        self.cfg = cfg
        self.args = args
        self.device = resolve_device(device)
        self.save_dir = getattr(args, "save_dir", None) or cfg.save_dir \
            or "./exp/default"
        self.ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        if rank() == 0:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.writer = Writer(
            log_dir=self.save_dir, rank=rank(),
            use_tensorboard=os.environ.get("USE_TFB") == "1")
        self.epoch = 0
        self.step = 0
        # best-checkpoint tracking, lower is better; -1: no eval yet
        self.best_eval_score = -1.0
        self.best_eval_epoch = 0
        self.snapshot_min = cfg.snapshot_min  # minutes between snapshots
        self._last_snapshot_time = time.time()
        self.train_loader = None
        self.test_loader = None

    def put_batch(self, x) -> torch.Tensor:
        """A numpy batch as a float32 tensor on the trainer's device."""
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    # ------------------------------------------------------------- data
    def build_data(self):
        loaders = get_data_loaders(
            as_view(self.cfg.data),
            root_dir=getattr(self.args, "data_root", None),
            seed=self.cfg.trainer.seed, num_shards=world(), shard_id=rank())
        self.train_loader = loaders["train_loader"]
        self.test_loader = loaders["test_loader"]
        ncat = len(self.train_loader.dataset.synset_ids)
        if self.cfg.data.cond_on_cat and ncat > self.cfg.data.nclass:
            # one_hot would fail on the labels past nclass (lion_tpu's
            # gives them zero rows)
            raise ValueError(f"data.cond_on_cat: data.cates names {ncat} "
                             f"categories, data.nclass {self.cfg.data.nclass}")

    # ------------------------------------------------------------- loop
    def train_epochs(self):
        cfg = self.cfg
        start_epoch = self.epoch
        steps_per_epoch = len(self.train_loader) if self.train_loader else 1
        # negative cadences count epochs (base_trainer.py:168-171)
        log_freq = cfg.viz.log_freq
        if log_freq <= -1:
            log_freq = int(-log_freq * steps_per_epoch)
        log_freq = max(log_freq, 1)
        viz_freq = cfg.viz.viz_freq
        if viz_freq <= -1:
            viz_freq = int(-viz_freq * steps_per_epoch)
        for epoch in range(start_epoch, cfg.trainer.epochs):
            self.epoch = epoch
            if self.train_loader is not None:
                self.train_loader.set_epoch(epoch)
            tic = time.time()
            for batch in (self.train_loader or []):
                metrics = self.train_iter(batch, step=self.step)
                self.step += 1
                if self.step % log_freq == 0:
                    # in sorted order, as lion_tpu's jitted steps return them
                    for k, v in sorted(metrics.items()):
                        self.writer.avg_meter(f"train/{k}", float(v))
                if viz_freq > 0 and self.step % viz_freq == 0:
                    self.vis_recont(batch, self.step)
                    self.vis_sample(self.step)
            epoch_time = time.time() - tic
            self.writer.add_scalar("train/epoch_time", epoch_time, epoch)
            self.writer.upload_meter(self.step)

            if (time.time() - self._last_snapshot_time
                    > self.snapshot_min * 60):
                self.save_snapshot()
                self._last_snapshot_time = time.time()
            if cfg.viz.save_freq > 0 and (epoch + 1) % cfg.viz.save_freq == 0:
                self.save(tag=f"epoch_{epoch}_iters_{self.step}")
            if cfg.viz.val_freq > 0 and (epoch + 1) % cfg.viz.val_freq == 0:
                eval_score = self.run_eval()
                if eval_score is not None and (
                        eval_score < self.best_eval_score
                        or self.best_eval_score < 0):
                    self.best_eval_score = float(eval_score)
                    self.best_eval_epoch = epoch
                    self.save(tag="best_eval")
                    self.writer.log(
                        f"new best eval score {self.best_eval_score:.6f} "
                        f"at epoch {epoch}")
                self.writer.add_scalar("eval/best_score",
                                       self.best_eval_score, self.step)
        self.save(tag="final")

    # ----------------------------------------------------- to implement
    def train_iter(self, batch, step: int) -> Dict[str, float]:
        raise NotImplementedError

    def run_eval(self) -> Optional[float]:
        """Periodic quality eval; a lower-is-better scalar for the
        best-checkpoint tracking, or None to skip it."""
        return None

    def vis_recont(self, batch, step: int):
        pass

    def vis_sample(self, step: int):
        pass

    def add_sample_grid(self, pts: torch.Tensor, step: int):
        """Sampled clouds (B, N, >= 3), each box-normalized, as the
        `vis/sample` grid titled gen-i."""
        clouds = normalize_point_clouds(pts[:, :, :3].float().cpu().numpy())
        img = visualize_point_clouds_3d(
            list(clouds), [f"gen-{i}" for i in range(len(clouds))])
        self.writer.add_image("vis/sample", img, step)

    def state_trees(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_state_trees(self, trees: Dict[str, Any], metadata: dict):
        raise NotImplementedError

    # ------------------------------------------------------------- ckpt
    def _metadata(self):
        return {"epoch": self.epoch, "step": self.step,
                "best_eval_score": self.best_eval_score,
                "best_eval_epoch": self.best_eval_epoch}

    def save(self, tag: str = "checkpoint"):
        if rank() != 0:
            return
        path = os.path.join(self.ckpt_dir, f"{tag}.npz")
        save_checkpoint(path, self.state_trees(), self._metadata())
        self.writer.log(f"saved {path}")

    def save_snapshot(self):
        if rank() != 0:
            return
        save_snapshot(self.ckpt_dir, self.state_trees(), self._metadata())
        self.writer.log("saved snapshot")

    def resume(self, path: Optional[str] = None) -> bool:
        """Resume from an explicit path or the preemption snapshot."""
        if path is None:
            if not has_snapshot(self.ckpt_dir):
                return False
            trees, metadata = load_snapshot(self.ckpt_dir)
        else:
            trees, metadata = load_checkpoint(path)
        self.load_state_trees(trees, metadata)
        self.epoch = int(metadata.get("epoch", 0))
        self.step = int(metadata.get("step", 0))
        self.best_eval_score = float(metadata.get("best_eval_score", -1.0))
        self.best_eval_epoch = int(metadata.get("best_eval_epoch", 0))
        self.writer.log(f"resumed at epoch {self.epoch} step {self.step}")
        return True
