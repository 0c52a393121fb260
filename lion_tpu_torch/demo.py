"""The demo / inference CLI (port of demo.py):

    python -m lion_tpu_torch.demo --config <exp>/cfg.yml [--ckpt CKPT]
        [--num_samples 4] [--ddim_step 0] [--seed 0] [--out samples.npz]
        [--plot grid.png] [--device cuda] [--text "a chair|a car"]
        [--clip_feat feats.npy]

loads a checkpoint (a released or exported `.pt`, or a trainer's `.npz`,
whose EMA priors it takes when there are some), samples shapes with the
whole hierarchy (DDIM with `--ddim_step` steps, else the ancestral chain,
in four segments from 500 steps up) and writes `points`, `z_global` and
`z_local` to `--out`, and a grid of scatters to `--plot`. Without a
checkpoint it samples from random weights drawn from `--seed`.

Text-to-shape (a config with clipforge.enable): `--text` encodes its
'|'-separated prompts with `utils.clip_helper.get_clip_encoder` (the
HashClip stand-in where no CLIP weights load; one prompt serves every
shape, else one prompt a shape), or `--clip_feat` reads precomputed
(num_samples, feat_dim) features from a `.npy` (demo.py:24-60). A config
without clipforge.enable refuses both.
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
                   help=".npy of precomputed CLIP features (text2shape)")
    p.add_argument("--text", type=str, default="",
                   help="text prompt(s), '|'-separated, encoded with CLIP "
                        "(reference demo.py:31-36)")
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


def clip_features(args):
    """The CLIP features of `--clip_feat` or `--text` (None without
    either), (num_samples, feat_dim) float32."""
    if args.clip_feat:
        return np.load(args.clip_feat).astype(np.float32)
    if not args.text:
        return None
    from .utils.clip_helper import get_clip_encoder
    enc = get_clip_encoder()
    if not enc.is_real:
        print("WARNING: no CLIP weights cached; using deterministic stub "
              "features (set LION_CLIP_MODEL to a local CLIP dir)")
    prompts = args.text.split("|")
    feats = enc.encode_text(prompts)
    # one prompt serves every sample; else one prompt a sample
    if len(prompts) == 1:
        feats = np.repeat(feats, args.num_samples, axis=0)
    return feats.astype(np.float32)


def main(argv=None):
    """Run the demo; returns the sampling output."""
    args = get_args(argv)
    import torch

    from .config import get_default_cfg
    from .models import LION

    cfg = get_default_cfg()
    cfg.merge_from_file(args.config)
    if (args.text or args.clip_feat) and not cfg.clipforge.enable:
        raise ValueError("--text / --clip_feat condition a CLIP prior: the "
                         "config needs clipforge.enable (this one would "
                         "ignore the features)")
    lion = LION(cfg, device=args.device)
    load_params(lion, args.ckpt, cfg, args.seed)
    clip_feat = clip_features(args)

    gen = torch.Generator(device=lion.device).manual_seed(args.seed)
    if args.ddim_step == 0 and cfg.ddpm.num_steps >= 500:
        # the long chain in segments, as demo.py runs it
        out = lion.sample_chunked(args.num_samples, gen, chunks=4,
                                  clip_feat=clip_feat)
    else:
        out = lion.sample(args.num_samples, gen, ddim_step=args.ddim_step,
                          clip_feat=clip_feat)
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
