"""The training and evaluation CLI (port of train_dist.py):

    python -m lion_tpu_torch.train_dist [--config cfg.yml] [--exp_root ./exp]
        [--data_root DIR] [--pretrained ckpt.npz] [--eval_generation]
        [--num_samples N] [--skip_sample] [--resume] [--device cuda]
        [--distributed_init [--dist_url env://]]
        key value key value ...

The config is the defaults, then `--config`, then the yacs-style `key
value` overrides, then `--data_root`. The experiment directory is
`{exp_root}/{data.cates}_{md5-6 of the config dump}` unless the config
sets `save_dir`; it receives `cfg.yml`, the checkpoints and
`metrics.jsonl`. The trainer is `trainers.get_trainer(cfg.trainer.type)`
on `--device`. It starts from `--pretrained` when given, else from the
experiment's preemption snapshot when there is one. `--eval_generation`
samples the category's reference count of shapes (or `--num_samples`)
into `<save_dir>/eval/samples.pt` and scores them against
`./datasets/test_data/ref_val_<cate>.pt` when that file exists.
`lion_tpu_torch/scripts/train_vae.sh` and `train_prior.sh` run the
released recipes through it. `trainer.type trainers.dit3d_trainer` (on
the command line or in the config file) trains DiT-3D instead: the tree
then holds the `dit3d` node (`config.default_cfg_for`).

Data parallel, one process a GPU: `torchrun --nproc_per_node=N -m
lion_tpu_torch.train_dist --distributed_init ...` (the scripts do so when
NGPU is above 1). `--distributed_init` joins the process group that
torchrun's environment describes (`parallel.dist.init_from_env`: NCCL on
cuda:LOCAL_RANK, gloo under `--device cpu`; `--dist_url` names another
rendezvous, e.g. file:///path). Every rank builds the same config and
trainer on its shard of the data; rank 0 alone writes the experiment
(cfg.yml, checkpoints, metrics.jsonl, the evaluation's files).
"""
from __future__ import annotations

import argparse
import hashlib
import os
import shlex


def get_args(argv=None):
    p = argparse.ArgumentParser("lion_tpu_torch train/eval")
    p.add_argument("--config", type=str, default="",
                   help="yaml config to merge over defaults")
    p.add_argument("--exp_root", type=str, default="./exp")
    p.add_argument("--data_root", type=str, default=None,
                   help="override cfg.data.data_dir")
    p.add_argument("--pretrained", type=str, default="",
                   help="checkpoint to load")
    p.add_argument("--eval_generation", action="store_true",
                   help="sample + score instead of training")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--skip_sample", action="store_true")
    p.add_argument("--num_samples", type=int, default=0,
                   help="override number of generated samples for eval")
    p.add_argument("--distributed_init", action="store_true",
                   help="join torchrun's process group (data parallel)")
    p.add_argument("--dist_url", type=str, default="env://",
                   help="the process group's rendezvous (--distributed_init)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the trainer runs on")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="yacs-style `key value` override pairs")
    return p.parse_args(argv)


def build_cfg(args):
    """The run's config; creates its experiment directory and writes
    `cfg.yml` there (rank 0 of a process group alone)."""
    from .parallel.dist import rank
    import yaml
    from .config import default_cfg_for
    tree = None
    if args.config:
        with open(args.config) as f:
            tree = yaml.safe_load(f)
    cfg = default_cfg_for(tree, args.opts or ())
    if args.config:
        cfg.merge_from_file(args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.data_root:
        cfg.data.data_dir = args.data_root
    # the experiment is named by the md5-6 of the config dump (reference
    # train_dist.py:181)
    cfg_hash = hashlib.md5(cfg.dump().encode()).hexdigest()[:6]
    if not cfg.hash:
        cfg.hash = cfg_hash
    if not cfg.save_dir:
        cfg.save_dir = os.path.join(args.exp_root,
                                    f"{cfg.data.cates}_{cfg_hash}")
    if rank() == 0:
        os.makedirs(cfg.save_dir, exist_ok=True)
        cfg.save(os.path.join(cfg.save_dir, "cfg.yml"))
    return cfg


def apply_debug_flags(cfg):
    """set_detect_anomaly: autograd's anomaly detection (reference
    train_dist.py:33-37), which slows training."""
    if cfg.set_detect_anomaly:
        import torch
        torch.autograd.set_detect_anomaly(True)
        print("!" * 30 + "\nWARNING: set_detect_anomaly is on; it can slow "
              "down training!\n" + "!" * 30)


def script_overrides(path: str, **values) -> list:
    """The `key value` overrides of a training script that runs this CLI
    (`lion_tpu_torch/scripts/*.sh`, or the JAX package's `scripts/*.sh`
    through `train_dist.py`), with each "$NAME" given in `values`; the
    script's own flags (`--data_root`) and the shell words left unexpanded
    (the launcher's, as "${DIST[@]}") are left out."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if "train_dist" in ln and not ln.lstrip().startswith("#"))
    for name, value in values.items():
        line = line.replace(f'"${name}"', shlex.quote(str(value)))
    words = shlex.split(line)
    words = words[next(i for i, w in enumerate(words)
                       if "train_dist" in w) + 1:]
    out = []
    while words:
        word = words.pop(0)
        if word.startswith("--"):
            words.pop(0)
        elif not word.startswith("$"):
            out.append(word)
    return out


def main(argv=None):
    """Run the CLI; returns the trainer. Under `--distributed_init` the
    process group it joins is left when the run ends."""
    args = get_args(argv)
    if not args.distributed_init:
        return _run(args)
    from .parallel.dist import init_from_env
    import torch.distributed as dist
    args.device = str(init_from_env(args.device, args.dist_url))
    try:
        return _run(args)
    finally:
        dist.destroy_process_group()


def _run(args):
    cfg = build_cfg(args)

    apply_debug_flags(cfg)

    from .trainers import get_trainer
    args.save_dir = cfg.save_dir
    trainer = get_trainer(cfg.trainer.type)(cfg, args, device=args.device)

    try:
        if args.pretrained:
            trainer.resume(args.pretrained)
        else:
            # snapshot auto-resume, always attempted (train_dist.py:60-69
            # sets args.resume whenever checkpoints/snapshot exists)
            resumed = trainer.resume(None)
            if args.resume and not resumed:
                print(f"WARNING: --resume given but no snapshot found under "
                      f"{trainer.ckpt_dir}; starting fresh")

        if args.eval_generation:
            run_eval_generation(trainer, cfg, args)
        else:
            trainer.train_epochs()
    finally:
        trainer.writer.close()
    return trainer


def run_eval_generation(trainer, cfg, args):
    """Sample num_ref shapes and score them (base_trainer.py eval_sample +
    eval_helper.compute_score); in a process group every rank samples
    and rank 0 writes and scores."""
    import numpy as np
    import torch

    from .eval import compute_score, get_cats, get_ref_num, get_ref_pt
    from .parallel.dist import rank

    cats = get_cats(cfg.data.cates)
    num_ref = args.num_samples or cfg.num_ref or get_ref_num(cats)
    batch = cfg.data.batch_size_test
    out_dir = os.path.join(cfg.save_dir, "eval")
    sample_path = os.path.join(out_dir, "samples.pt")

    if not args.skip_sample or not os.path.exists(sample_path):
        all_pcs = []
        seed = cfg.trainer.seed
        for i in range(0, num_ref, batch):
            n = min(batch, num_ref - i)
            # per-iteration reseed (base_trainer.py:459-463)
            gen = torch.Generator(device=trainer.device).manual_seed(seed + i)
            pts = trainer.sample(n, generator=gen,
                                 ddim_step=cfg.eval_ddim_step)
            all_pcs.append(pts.float().cpu().numpy())
            print(f"sampled {i + n}/{num_ref}")
        samples = np.concatenate(all_pcs)[:num_ref]
        if rank() == 0:
            os.makedirs(out_dir, exist_ok=True)
            torch.save(torch.from_numpy(samples), sample_path)
    if rank() != 0:
        return

    ref_path = get_ref_pt(cats, cfg.data.type)   # under ./datasets/test_data/
    if ref_path and os.path.exists(ref_path):
        compute_score(sample_path, ref_path, dataset=cats, hash=cfg.hash,
                      step=trainer.step, device=trainer.device,
                      results_dir=os.path.join(cfg.save_dir, "results"))
    else:
        print(f"reference set not found ({ref_path}); samples saved to "
              f"{sample_path}")


if __name__ == "__main__":
    main()
