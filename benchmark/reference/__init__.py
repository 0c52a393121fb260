"""The plain reference of the benchmark: LION in plain PyTorch, float32,
with no kernel of the measured program (`ops`, `model`), its DDIM sampler
and training noise (`diffusion`) and its two training objectives with Adam
and the EMA (`train`). It imports nothing of the program; the benchmark
hands it the weights and inputs it made itself.

`work_of` gives one request's or one step's work of a mix, for counting on
the meta device (`benchmark.work`).
"""
from __future__ import annotations

import contextlib

import torch

from .diffusion import Schedule
from .model import Lion
from .train import prior_loss, vae_loss


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuBLAS and cuDNN inside the block; the previous
    settings come back after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def work_of(cfg: dict, mix: dict, device):
    """A function that runs one unit of `mix` (a sampling request, or a
    training step's forward and backward) on the reference, built on
    `device` with uninitialized weights and zero inputs."""
    with torch.device(device):
        lion = Lion(cfg)
    b = mix["batch"]
    n = cfg["data"]["tr_max_sample_points"]
    style = cfg["latent_pts"]["style_dim"]
    clip = torch.zeros(b, cfg["clipforge"]["feat_dim"], device=device) \
        if cfg["clipforge"]["enable"] else None
    kind = mix["kind"]

    def sample():
        lion.eval()
        c = lion.local_prior.c
        with torch.no_grad():
            zg = torch.zeros(b, style, device=device)
            zl = torch.zeros(b, n, c, device=device)
            t = torch.ones(b, device=device)
            for _ in range(mix["ddim_step"]):
                lion.global_prior(zg, t, clip_feat=clip)
            for _ in range(mix["ddim_step"]):
                lion.local_prior(zl, t, zg, clip_feat=clip)
            lion.vae.decode(zg, zl.reshape(b, -1))

    def train():
        x = torch.zeros(b, n, 3, device=device)
        if kind == "train_vae":
            loss = vae_loss(cfg, lion.vae, x, None, 1.0)[0]
        else:
            loss = prior_loss(cfg, lion, x, None, clip_feat=clip)[0]
        loss.backward()

    return sample if kind == "sample" else train


__all__ = ["Schedule", "Lion", "prior_loss", "vae_loss", "no_tf32",
           "work_of"]
