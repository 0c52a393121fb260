"""The demo / inference CLI (port of demo.py):

    python -m lion_tpu_torch.demo --config <exp>/cfg.yml [--ckpt CKPT]
        [--num_samples 4] [--ddim_step 0] [--seed 0] [--out samples.npz]
        [--plot grid.png] [--device cuda]

loads a checkpoint (a released or exported `.pt`, or a trainer's `.npz`,
whose EMA priors it takes when there are some), samples shapes with the
whole hierarchy (DDIM with `--ddim_step` steps, else the ancestral chain,
in four segments from 500 steps up) and writes `points`, `z_global` and
`z_local` to `--out`, and a grid of scatters to `--plot`. Without a
checkpoint it samples from random weights drawn from `--seed`. Text and
CLIP-feature conditioning (`--text`, `--clip_feat`) are ROADMAP Queue 1
item J2.
"""
import argparse

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser("lion_tpu_torch demo")
    p.add_argument("--config", type=str, required=True,
                   help="cfg.yml from the checkpoint directory")
    p.add_argument("--ckpt", type=str, default="",
                   help="model checkpoint (.pt torch or .npz native)")
    p.add_argument("--num_samples", type=int, default=4)
    p.add_argument("--ddim_step", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip_feat", type=str, default="",
                   help=".npy of precomputed CLIP features (not ported)")
    p.add_argument("--text", type=str, default="",
                   help="text prompt(s) (not ported)")
    p.add_argument("--out", type=str, default="./samples.npz")
    p.add_argument("--plot", type=str, default="",
                   help="optional .png path for a matplotlib 3D scatter")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the model samples on")
    return p.parse_args(argv)


def load_params(lion, ckpt: str, cfg, seed: int):
    """The model's weights: a `.pt` through `ckpt.load_lion_checkpoint`;
    an `.npz` through `ckpt.io` (the VAE, then ema_global / ema_local when
    present, else dae_*; demo.py:41-52); random weights from `seed`
    without a checkpoint."""
    import torch

    from .ckpt import load_checkpoint, load_lion_checkpoint
    if ckpt.endswith(".pt"):
        lion.load_jax_params(load_lion_checkpoint(ckpt, cfg))
    elif ckpt:
        trees, _ = load_checkpoint(ckpt)
        lion.load_jax_params({
            "vae": trees["vae"],
            "global_prior": trees.get("ema_global", trees["dae_global"]),
            "local_prior": trees.get("ema_local", trees["dae_local"]),
        })
    else:
        print("WARNING: no checkpoint given; sampling from random init")
        lion.init_params(torch.Generator().manual_seed(seed))


def main(argv=None):
    """Run the demo; returns the sampling output."""
    args = get_args(argv)
    if args.text or args.clip_feat:
        raise NotImplementedError(
            "--text / --clip_feat: CLIP conditioning is not ported (ROADMAP "
            "Queue 1 item J2)")
    import torch

    from .config import get_default_cfg
    from .models import LION

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config)
    lion = LION(cfg, device=args.device)
    load_params(lion, args.ckpt, cfg, args.seed)

    gen = torch.Generator(device=lion.device).manual_seed(args.seed)
    if args.ddim_step == 0 and cfg.ddpm.num_steps >= 500:
        # the long chain in segments, as demo.py runs it
        out = lion.sample_chunked(args.num_samples, gen, chunks=4)
    else:
        out = lion.sample(args.num_samples, gen, ddim_step=args.ddim_step)
    pts = out["points"].float().cpu().numpy()
    np.savez(args.out, points=pts,
             z_global=out["z_global"].float().cpu().numpy(),
             z_local=out["z_local"].float().cpu().numpy())
    print(f"saved {pts.shape} samples to {args.out}")

    if args.plot:
        from .utils.vis import plot_points
        plot_points(pts, args.plot)
        print(f"saved plot to {args.plot}")
    return out


if __name__ == "__main__":
    main()
