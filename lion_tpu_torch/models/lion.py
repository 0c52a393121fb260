"""LION: the public sampling API (port of lion_tpu/models/lion.py, the
ancestral DDPM branch).

`LION(cfg)` holds the VAE decoder and the two priors as one nn.Module whose
parameter names are the JAX package's param-tree paths. `sample(n)` runs
the hierarchy:

    global prior: T ancestral steps over the 2048-wide ResNet
    local prior:  T ancestral steps over the PVCNN2 U-Net, conditioned on
                  the global sample; the latent is carried as (B, N, C)
    decode:       one U-Net forward of the VAE decoder

fp32 only. DDIM, the PF-ODE, class and CLIP conditioning and released .pt
checkpoints are not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional

import torch
from torch import nn

from ..ckpt.from_jax import LION_SKIPPED_PREFIXES, state_dict_from_jax
from ..config.view import as_view
from ..diffusion.discrete import DiffusionDiscretized, randn
from ..nn.common import init_weights
from .registry import build_global_prior, build_local_prior
from .vae import VAE


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LION(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        view = as_view(cfg)
        self.cfg = cfg
        self.vae = VAE(cfg)
        self.global_prior = build_global_prior(view)
        self.local_prior = build_local_prior(view)
        self.diffusion = DiffusionDiscretized(view)
        self.mixed_prediction = bool(view.sde.mixed_prediction)
        self.num_points = view.data.tr_max_sample_points
        self.style_dim = view.latent_pts.style_dim
        self.point_channels = view.shapelatent.latent_dim + view.ddpm.input_dim
        self.local_dim = self.num_points * self.point_channels

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, generator: torch.Generator) -> "LION":
        """Draw every parameter with the JAX package's initializers."""
        init_weights(self, generator)
        return self

    def load_jax_params(self, tree) -> "LION":
        """Load LION's JAX params ({'vae', 'global_prior', 'local_prior'}
        nested dicts of numpy arrays); the VAE encoders are skipped."""
        self.load_state_dict(
            state_dict_from_jax(tree, LION_SKIPPED_PREFIXES), strict=True)
        return self

    @torch.no_grad()
    def sample(self, num_samples: int = 10,
               generator: Optional[torch.Generator] = None,
               given_noise=None) -> dict:
        """Hierarchical ancestral DDPM sampling.

        `given_noise`: optional ((init_g, steps_g), (init_l, steps_l)) with
        init (B, D) and steps (T, B, D) tensors replacing every Gaussian
        draw of the two chains (lion_tpu's given_noise). Returns z_global
        (B, style), z_local (B, N*C), points (B, N, 3) and the wall seconds
        of each stage (`stage_seconds`, after a device sync)."""
        return self._sample(num_samples, generator, given_noise, chunks=1)

    @torch.no_grad()
    def sample_chunked(self, num_samples: int,
                       generator: Optional[torch.Generator] = None,
                       chunks: int = 4) -> dict:
        """`sample` with each chain run as `chunks` equal segments (the JAX
        package splits its device programs so; here the segments run back
        to back and give the same samples as `sample`)."""
        if self.diffusion.num_steps % chunks:
            raise ValueError(f"chunks ({chunks}) must divide ddpm.num_steps "
                             f"({self.diffusion.num_steps})")
        return self._sample(num_samples, generator, None, chunks)

    def _chain(self, model_fn, x, generator, mixing_logit, given_noise,
               chunks: int):
        ts = range(self.diffusion.num_steps - 1, -1, -1)
        seg = len(ts) // chunks
        for i in range(chunks):
            x = self.diffusion._denoise_ts(
                model_fn, x, ts[i * seg:(i + 1) * seg], generator,
                mixing_logit=mixing_logit, given_noise=given_noise)
        return x

    def _sample(self, num_samples, generator, given_noise, chunks):
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        (x_g, noise_g), (x_l, noise_l) = given_noise or ((None, None),
                                                         (None, None))
        mix_g = self.global_prior.mixing_logit if self.mixed_prediction \
            else None
        mix_l = self.local_prior.mixing_logit if self.mixed_prediction \
            else None
        seconds = {}

        t0 = time.perf_counter()
        shape_g = (num_samples, self.style_dim)
        x = randn(shape_g, generator, dev) if x_g is None \
            else x_g.reshape(shape_g).to(dev)
        z_global = self._chain(self.global_prior, x, generator, mix_g,
                               noise_g, chunks)
        _sync(dev)
        t1 = time.perf_counter()
        seconds["global"] = t1 - t0

        shape_l = (num_samples, self.num_points, self.point_channels)
        x = randn(shape_l, generator, dev) if x_l is None \
            else x_l.reshape(shape_l).to(dev)
        z_local = self._chain(
            lambda xx, t: self.local_prior(xx, t, condition_input=z_global),
            x, generator, mix_l, noise_l, chunks)
        z_local = z_local.reshape(num_samples, self.local_dim)
        _sync(dev)
        t2 = time.perf_counter()
        seconds["local"] = t2 - t1

        points = self.vae.sample(num_samples, [z_global, z_local])
        _sync(dev)
        seconds["decode"] = time.perf_counter() - t2
        return {"z_global": z_global, "z_local": z_local, "points": points,
                "stage_seconds": seconds}
