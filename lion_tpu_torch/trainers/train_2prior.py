"""The stage-2 two-prior trainer (port of lion_tpu/trainers/train_2prior.py).

    Trainer(cfg, args, device="cuda").train_epochs()

loads the ShapeNet15k split of cfg.data, builds the VAE (random weights
from trainer.seed, then the stage-1 weights of `sde.vae_checkpoint`: an
`.npz` of either package's stage-1 `Trainer` or a `.pt` holding
`ckpt["model"]`), and trains the global and the local prior of a `LION`
around that frozen VAE with `make_prior_train_step`: Adam with
sde.grad_clip_max_norm on the warmup-cosine schedule of
sde.learning_rate_dae / learning_rate_min_dae / warmup_epochs / epochs,
and the EMA at sde.ema_decay; under sde.ode_sample on the continuous
diffusion, under `pvd_mse_loss = 0` the weighted objective with its
regularizers (the spectral norm's power-iteration state is drawn at build
and not checkpointed, as in the JAX package). Every `viz.val_freq` epochs
`run_eval` samples `num_val_samples` shapes from the EMA priors
(`eval_ddim_step` DDIM steps, or the PF-ODE under sde.ode_sample) and
scores them against the test split (`eval_sample`); its 1-NNA-CD tracks
the best checkpoint. Checkpoints go
to `<save_dir>/checkpoints/*.npz` in the JAX package's layout (trees
dae_global, dae_local, vae, opt, ema_global, ema_local), so either package
resumes the other's; `export_torch` writes the released `.pt` schema.

Under tpu.bf16 (or sde.autocast_train) the U-Nets compute in bf16 while
the parameters, Adam, the EMA and the checkpoints stay float32, so a bf16
run and a float32 run read each other's checkpoints. Every `viz.viz_freq`
steps `vis_sample` draws a grid of samples (`viz.vis_sample_ddim_step`
DDIM steps) into `<save_dir>/images/`; it needs matplotlib, which the
trainer checks when it is built.

Conditioning (lion_tpu/trainers/train_2prior.py:93-120, 154-245): under
data.cond_on_cat each step reads the batch's `cate_idx` and `sample`
conditions on the labels arange(n) % data.nclass; under clipforge.enable
a CLIP encoder (`utils.clip_helper.get_clip_encoder`: the HashClip stand-in
where no CLIP weights load; LION_REQUIRE_CLIP=1 makes that an error)
encodes each batch's render views (data.clip_forge_enable), mean-pooled
over the views, and `sample` takes the first test batch's features.

Data parallel (base.py): `sample` splits its rows over the ranks
(`LION.sample_chunked(group=)`) when the chain is chunked and the count
divides the world; `eval_sample` has each rank generate its share of the
clouds and gathers them in rank order; rank 0 scores them, and the
decision that no reference set exists reaches every rank.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ckpt.io import (adam_state_from_tree, adam_state_tree,
                       export_torch_checkpoint, load_checkpoint,
                       load_tensors_tree, module_arrays, tensors_tree)
from ..ckpt.torch_import import import_state_dict, module_tree
from ..eval.eval_helper import (NUM_TEST, _load_pt, get_cats, get_ref_num,
                                get_ref_pt, normalize_point_clouds,
                                print_results, write_results)
from ..eval.metrics import compute_all_metrics, jsd_between_point_cloud_sets
from ..models.lion import LION
from ..models.vae import VAE
from ..nn.common import init_weights
from ..parallel.dist import (broadcast_flag, fold_seed, gather_rows, rank,
                             world)
from .base import BaseTrainer
from .steps import default_lr_schedule, make_prior_train_step

# eval_sample's answer, on every rank, when no reference set exists (no
# released reference .pt and no test split): the callers fall back to a
# sanity statistic together; rank > 0 otherwise gets None
NO_REFS = object()

# eval_sample's metric keys -> the scalar tags it logs
# (base_trainer.py:540-548)
TEST_TAGS = {"lgan_cov-CD": "test/Coverage_CD",
             "lgan_cov-EMD": "test/Coverage_EMD",
             "lgan_mmd-CD": "test/MMD_CD",
             "lgan_mmd-EMD": "test/MMD_EMD",
             "1-NN-CD-acc": "test/1NN_CD",
             "1-NN-EMD-acc": "test/1NN_EMD",
             "jsd": "test/JSD"}


def _ensure_csv(save_dir: str) -> str:
    d = os.path.join(save_dir, "results")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "eval_out.csv")


class Trainer(BaseTrainer):
    def __init__(self, cfg, args, device="cuda"):
        self.check_config(cfg)
        if cfg.clipforge.enable and not cfg.data.clip_forge_enable:
            raise ValueError("clipforge.enable: the trainer encodes the "
                             "render views of data.clip_forge_enable, which "
                             "is off")
        super().__init__(cfg, args, device)
        self.build_data()
        self.build_model()
        self.build_prior()

    @classmethod
    def check_config(cls, cfg) -> None:
        """Raise for a configuration the trainer does not run (the
        two-prior trainer runs every one)."""

    # ------------------------------------------------------------- build
    def _steps_per_epoch(self) -> int:
        return max(len(self.train_loader), 1) if self.train_loader else 1

    def build_model(self):
        """The VAE, drawn from trainer.seed, then the stage-1 weights of
        sde.vae_checkpoint when it is set."""
        cfg = self.cfg
        with self.device:
            self.vae = VAE(cfg)
        init_weights(self.vae, torch.Generator().manual_seed(cfg.trainer.seed))
        if cfg.sde.vae_checkpoint:
            self.load_vae_checkpoint(cfg.sde.vae_checkpoint)

    def load_vae_checkpoint(self, path: str):
        """The VAE's weights from a stage-1 checkpoint: a `.pt` holding the
        reference layout's state_dict under "model", or an `.npz` of either
        package's stage-1 Trainer (its "model" tree)."""
        if path.endswith(".pt"):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            tree = import_state_dict(ckpt["model"], module_tree(self.vae),
                                     "vae")
        else:
            trees, _ = load_checkpoint(path)
            tree = trees["model"]
        names, tensors = zip(*self.vae.named_parameters())
        load_tensors_tree(names, tensors, tree)
        self.writer.log(f"loaded VAE checkpoint from {path}")

    def build_prior(self):
        """The two priors of a LION around the frozen VAE, drawn from
        trainer.seed + 1, and their step: Adam on the warmup-cosine
        schedule over this run's steps per epoch, the EMA at
        sde.ema_decay."""
        cfg = self.cfg
        self.lion = LION(cfg, self.device, vae=self.vae)
        gen = torch.Generator().manual_seed(cfg.trainer.seed + 1)
        init_weights(self.lion.global_prior, gen)
        init_weights(self.lion.local_prior, gen)
        self.step_fn = make_prior_train_step(
            self.lion, default_lr_schedule(cfg, self._steps_per_epoch()),
            self.device)
        self.param_names = [f"{prior}.{n}"
                            for prior in ("global_prior", "local_prior")
                            for n, _ in getattr(self.lion,
                                                prior).named_parameters()]
        self.generator = torch.Generator(device=self.device).manual_seed(
            fold_seed(cfg.trainer.seed, 13))
        self.build_clip_encoder()

    def build_clip_encoder(self):
        """The CLIP encoder of clipforge.enable (None without it): real CLIP
        when its weights load, else the HashClip stand-in with a warning;
        LION_REQUIRE_CLIP=1 turns the stand-in into an error."""
        self.clip_encoder = None
        if not self.cfg.clipforge.enable:
            return
        from ..utils.clip_helper import get_clip_encoder
        require = os.environ.get("LION_REQUIRE_CLIP", "0") == "1"
        self.clip_encoder = get_clip_encoder(
            self.cfg.clipforge.clip_model, normalize=False,
            allow_fallback=not require)
        if not self.clip_encoder.is_real:
            self.writer.log("WARNING: CLIP weights unavailable; using "
                            "HashClip pseudo-features (clipforge). Set "
                            "LION_CLIP_MODEL to a local weight dir or "
                            "LION_REQUIRE_CLIP=1 to fail instead")

    # ------------------------------------------------------------- train
    def _batch_clip_feat(self, batch) -> Optional[np.ndarray]:
        """The batch's CLIP image features: its (B, nimg, H, W, 3) render
        views encoded and mean-pooled over the views
        (train_2prior.py:248-258); None without clipforge.enable."""
        if self.clip_encoder is None:
            return None
        tr_img = batch.get("tr_img")
        if tr_img is None:
            raise ValueError("clipforge.enable needs the render images of "
                             "data.clip_forge_enable in the batch")
        b, nimg = tr_img.shape[:2]
        flat = tr_img.reshape(b * nimg, *tr_img.shape[2:])
        feat = self.clip_encoder.encode_image(flat)
        return feat.reshape(b, nimg, -1).mean(axis=1).astype(np.float32)

    def conditions(self, batch) -> dict:
        """The step's conditioning inputs of a batch: `class_label` from its
        cate_idx under data.cond_on_cat, `clip_feat` from its render views
        under clipforge.enable."""
        cond = {}
        if self.cfg.data.cond_on_cat:
            cond["class_label"] = torch.as_tensor(
                np.asarray(batch["cate_idx"]), dtype=torch.long,
                device=self.device)
        feat = self._batch_clip_feat(batch)
        if feat is not None:
            cond["clip_feat"] = self.put_batch(feat)
        return cond

    def train_iter(self, batch, step: int, **draws) -> Dict[str, float]:
        """One step on the batch's clouds; the draws come from the
        trainer's generator unless given (`prior_loss`'s rho, timestep,
        noise)."""
        x = self.put_batch(batch["tr_points"])
        metrics = self.step_fn(x, self.generator, **self.conditions(batch),
                               **draws)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------ sample
    @contextlib.contextmanager
    def as_lion(self, use_ema: bool = True):
        """The trainer's LION, with the EMA copy of the priors in their
        parameters inside the block when `use_ema` (the trained values
        come back after it)."""
        ema = self.step_fn.ema if use_ema else None
        with ema.swapped() if ema is not None else contextlib.nullcontext():
            yield self.lion

    def _test_clip_feat(self, num: int) -> Optional[np.ndarray]:
        """CLIP features for sampling: the first test batch's, tiled or cut
        to `num` rows (base_trainer.py:646-709); None without
        clipforge.enable or a test split."""
        if self.clip_encoder is None:
            return None
        if getattr(self, "_clip_feat_test", None) is None:
            batch = next(iter(self.test_loader or []), None)
            if batch is None:
                return None
            self._clip_feat_test = self._batch_clip_feat(batch)
        feat = self._clip_feat_test
        reps = (num + len(feat) - 1) // len(feat)
        return np.tile(feat, (reps, 1))[:num]

    def sample(self, num_samples: int = 16, generator=None,
               use_ema: bool = True, ddim_step: int = 0,
               given_noise=None, clip_feat=None,
               local: bool = False) -> torch.Tensor:
        """Hierarchical sampling from the (EMA) priors -> points (B, N, 3):
        the ancestral chain in 4 segments (`sample_chunked`) when
        ddim_step is 0, the chain has 500 steps or more and sde.ode_sample
        is off, else `LION.sample(..., ddim_step)`, the PF-ODE under
        sde.ode_sample (lion_tpu/trainers/train_2prior.py:230-261). Under
        data.cond_on_cat the labels are arange(num_samples) % data.nclass;
        under clipforge.enable `clip_feat` defaults to the test split's.
        Inside a process group the chunked chain splits its rows over the
        ranks when the count divides the world, unless `local` (a call
        that not every rank makes)."""
        gen = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)
        cond = {}
        if self.cfg.data.cond_on_cat:
            cond["class_label"] = torch.arange(
                num_samples, device=self.device) % self.cfg.data.nclass
        if clip_feat is None:
            clip_feat = self._test_clip_feat(num_samples)
        if clip_feat is not None:
            cond["clip_feat"] = clip_feat
        with self.as_lion(use_ema) as lion:
            if (ddim_step == 0 and lion.diffusion.num_steps >= 500
                    and not self.cfg.sde.ode_sample):
                if not local and world() > 1 and \
                        num_samples % world() == 0:
                    import torch.distributed as dist
                    cond["group"] = dist.group.WORLD
                out = lion.sample_chunked(num_samples, gen, chunks=4,
                                          given_noise=given_noise, **cond)
            else:
                out = lion.sample(num_samples, gen, given_noise=given_noise,
                                  ddim_step=ddim_step, **cond)
        return out["points"]

    # -------------------------------------------------------------- eval
    def run_eval(self) -> Optional[float]:
        """The in-training sample eval: `num_val_samples` shapes scored on
        CD against the test split; its 1-NN-CD accuracy for the
        best-checkpoint tracking. Without references it logs the samples'
        mean |x| and returns None."""
        n = max(int(self.cfg.num_val_samples), 2)
        results = self.eval_sample(self.step, num_gen=n, metric2=None,
                                   save_samples=False)
        if results is NO_REFS:
            # every rank samples together; rank 0 logs
            pts = self.sample(n)
            self.writer.add_scalar("eval/sample_abs_mean",
                                   float(pts.abs().mean()), self.step)
            return None
        if results is None:     # rank > 0: rank 0 scored
            return None
        return float(results["1-NN-CD-acc"])

    def _test_refs(self, num: int):
        """`num` reference clouds of the test split and their training-set
        statistics (m, s), each (num, 1, 3); (None, None, None) without a
        test split."""
        refs, ms, ss = [], [], []
        got = 0
        for batch in (self.test_loader or []):
            refs.append(np.asarray(batch["tr_points"], np.float32))
            ms.append(np.asarray(batch["mean"], np.float32))
            ss.append(np.asarray(batch["std"], np.float32))
            got += refs[-1].shape[0]
            if got >= num:
                break
        if not refs:
            return None, None, None
        refs = np.concatenate(refs)[:num]
        m = np.concatenate(ms)[:num].reshape(len(refs), 1, -1)
        s = np.concatenate(ss)[:num].reshape(len(refs), 1, -1)
        return refs, m, s

    def _load_refs(self, num_gen: int):
        """The reference set: the released reference .pt of the category
        when it exists, else the test split -> (ref_pcs, m, s), or None."""
        cfg = self.cfg
        ref_path = get_ref_pt(get_cats(cfg.data.cates), cfg.data.type)
        if ref_path and os.path.exists(ref_path):
            ref = _load_pt(ref_path)
            ref_pcs = np.asarray(ref["ref"], np.float32)[:num_gen, :, :3]
            m = np.asarray(ref["mean"], np.float32)[:num_gen]
            s = np.asarray(ref["std"], np.float32)[:num_gen]
            return (ref_pcs, m.reshape(len(ref_pcs), 1, -1),
                    s.reshape(len(ref_pcs), 1, -1))
        ref_pcs, m, s = self._test_refs(num_gen)
        if ref_pcs is None:
            return None
        return ref_pcs, m, s

    def eval_sample(self, step: int = 0, num_gen: int = 0,
                    metric2: Optional[str] = "EMD",
                    save_samples: bool = True):
        """Generate and score (base_trainer.py:380-561): `num_gen` shapes
        (cfg.num_ref, the category's test-set size, else
        data.batch_size_test when 0) in batches of data.batch_size_test,
        each batch from a generator seeded trainer.seed + i; written to
        `<save_dir>/samples_<step>.pt`; scored against the reference set
        (MMD / COV / 1-NNA under CD and `metric2`, and JSD) after the
        shape-box normalization or the de-normalization by the
        references' statistics; the test/* scalars logged and the results
        appended to `eval_out.txt` and `results/eval_out.csv`. Returns the
        results, or NO_REFS without a reference set.

        Inside a process group each rank generates ceil(num_gen / world)
        shapes, from generators seeded trainer.seed + i + 7919 rank, and
        the clouds are gathered in rank order and cut to num_gen; rank 0
        decides whether references exist and tells every rank, so NO_REFS
        comes back on all of them; ranks above 0 return None otherwise
        (lion_tpu/trainers/train_2prior.py:350-383)."""
        cfg = self.cfg
        cats = get_cats(cfg.data.cates)
        if num_gen <= 0:
            num_gen = cfg.num_ref or (get_ref_num(cats) if cats in NUM_TEST
                                      else cfg.data.batch_size_test)
        batch = min(cfg.data.batch_size_test, num_gen)
        per_rank = -(-num_gen // world())
        gen_pcs = []
        for i in range(0, per_rank, batch):
            gen = torch.Generator(device=self.device).manual_seed(
                cfg.trainer.seed + i + rank() * 7919)
            pts = self.sample(min(batch, per_rank - i), generator=gen,
                              ddim_step=cfg.eval_ddim_step, local=True)
            gen_pcs.append(pts[:, :, :3].float())
        gen_pcs = gather_rows(torch.cat(gen_pcs))[:num_gen].cpu().numpy()

        refs = self._load_refs(num_gen) if rank() == 0 else None
        if not broadcast_flag(refs is not None):
            return NO_REFS
        if rank() != 0:
            return None
        ref_pcs, m, s = refs
        if save_samples:
            out_name = os.path.join(self.save_dir, f"samples_{step}.pt")
            torch.save(torch.from_numpy(gen_pcs), out_name)
            self.writer.log(f"saved {gen_pcs.shape} samples to {out_name}")

        norm_box = bool(cfg.data.recenter_per_shape
                        or cfg.data.normalize_shape_box)
        n = min(len(ref_pcs), len(gen_pcs))
        ref_pcs, gen_pcs, m, s = ref_pcs[:n], gen_pcs[:n], m[:n], s[:n]
        if norm_box:
            ref_pcs = 0.5 * normalize_point_clouds(ref_pcs)
            gen_pcs = 0.5 * normalize_point_clouds(gen_pcs)
        else:
            ref_pcs = ref_pcs * s + m
            gen_pcs = gen_pcs * s + m
        gen_pcs = gen_pcs.astype(np.float32)
        ref_pcs = ref_pcs.astype(np.float32)
        results = compute_all_metrics(gen_pcs, ref_pcs, metric2=metric2,
                                      device=self.device)
        results["jsd"] = jsd_between_point_cloud_sets(gen_pcs, ref_pcs,
                                                      device=self.device)
        for k, tag in TEST_TAGS.items():
            if k in results:
                self.writer.add_scalar(tag, float(results[k]), step)
        kwargs = {"dataset": cats, "hash": cfg.hash,
                  "step": "%dk" % (step / 1000.0),
                  "epoch": "%.1fk" % (self.epoch / 1000.0)}
        msg = print_results(results, **kwargs)
        with open(os.path.join(self.save_dir, "eval_out.txt"), "a") as f:
            f.write(msg + "\n")
        write_results(_ensure_csv(self.save_dir), results, **kwargs)
        return results

    def vis_sample(self, step: int):
        """The sample grid: min(num_val_samples, 8) shapes from the EMA
        priors at viz.vis_sample_ddim_step DDIM steps (0: the chain; a
        generator seeded `step`), normalized, as `vis/sample`
        (lion_tpu/trainers/train_2prior.py:436-450). The single-prior and
        the interpolation trainers draw it through their own `sample`."""
        n = min(self.cfg.num_val_samples, 8)
        gen = torch.Generator(device=self.device).manual_seed(step)
        self.add_sample_grid(self.sample(
            n, generator=gen, ddim_step=self.cfg.viz.vis_sample_ddim_step,
            local=True), step)

    # -------------------------------------------------------------- ckpt
    def state_trees(self):
        step, lion = self.step_fn, self.lion
        mu, nu = step.optimizer.moments()
        trees = {"dae_global": module_arrays(lion.global_prior),
                 "dae_local": module_arrays(lion.local_prior),
                 "vae": module_arrays(self.vae),
                 "opt": adam_state_tree(step.optimizer.count, mu, nu,
                                        self.param_names)}
        if step.ema is not None:
            ema = tensors_tree(self.param_names, step.ema.shadow)
            trees["ema_global"] = ema["global_prior"]
            trees["ema_local"] = ema["local_prior"]
        return trees

    def load_state_trees(self, trees, metadata):
        step, names = self.step_fn, self.param_names
        load_tensors_tree(names, step.params,
                          {"global_prior": trees["dae_global"],
                           "local_prior": trees["dae_local"]})
        if "opt" in trees:
            step.optimizer.load_state(*adam_state_from_tree(trees["opt"],
                                                            names))
        if "ema_global" in trees and step.ema is not None:
            load_tensors_tree(names, step.ema.shadow,
                              {"global_prior": trees["ema_global"],
                               "local_prior": trees["ema_local"]})
        if "vae" in trees:
            vae_names, vae_tensors = zip(*self.vae.named_parameters())
            load_tensors_tree(vae_names, vae_tensors, trees["vae"])
        step.optimizer.count = int(metadata.get("step", 0))

    def export_torch(self, path: str):
        """The released .pt schema (export_torch_checkpoint) with the EMA
        priors, as released checkpoints hold them."""
        with self.as_lion() as lion:
            export_torch_checkpoint(
                path, module_arrays(self.vae),
                module_arrays(lion.global_prior),
                module_arrays(lion.local_prior),
                epoch=self.epoch, global_step=self.step)
