"""LION: the model and its sampling API (port of lion_tpu/models/lion.py,
the ancestral DDPM branch); the priors' training step is
`trainers.make_prior_train_step`.

`LION(cfg, device="cuda")` holds the VAE (encoders and decoder) and the two
priors as one nn.Module whose parameter names are the JAX package's
param-tree paths, on the card unless the caller asks for `device="cpu"`;
without CUDA the default raises. `sample(n)` runs, in eval mode, the
hierarchy:

    global prior: T ancestral steps over the 2048-wide ResNet
    local prior:  T ancestral steps over the PVCNN2 U-Net, conditioned on
                  the global sample; the latent is carried as (B, N, C)
    decode:       one U-Net forward of the VAE decoder

With `ddim_step > 0` both chains take the DDIM sampler's `ddim_step`
steps instead (`cfg.sde.ddim_skip_type`, `cfg.sde.ddim_kappa`), as the
evaluation samples (`cfg.eval_ddim_step`). With `cfg.sde.ode_sample` set,
both priors sample by the probability-flow ODE of the continuous VPSDE
(`diffusion.continuous`; adaptive dopri5 at `cfg.sde.ode_solver_tol` from
t = 1 to `cfg.sde.ode_eps`) and the output gains the number of function
evaluations (`nfe`). With `cfg.tpu.bf16 = True` the local prior's and the
decoder's U-Nets compute in bf16; the global prior, the parameters and
the chains stay fp32. A released .pt loads through
`ckpt.load_lion_checkpoint` and `load_jax_params`.

Conditioning (lion_tpu/models/lion.py:101-106, 178-190, 234-283): under
`data.cond_on_cat` the samplers take `class_label` ((B,) ints or one-hot
rows): the local prior is conditioned on concat([z_global, cls_emb]) with
the frozen VAE's class embedding, and the decoder takes the label; the
PF-ODE refuses labels, as the JAX package does. Under `clipforge.enable`
they take `clip_feat` (B, clipforge.feat_dim), which both priors read.
`sample_chunked(group=)` splits the rows over the ranks of a process group
and gathers them back on every rank (lion_tpu's `mesh`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ckpt.from_jax import state_dict_from_jax
from ..config.view import as_view
from ..diffusion.continuous import make_diffusion
from ..diffusion.discrete import DiffusionDiscretized, randn
from ..nn.common import init_weights
from ..parallel.dist import gather_rows
from ..utils.spans import span
from .registry import build_global_prior, build_local_prior
from .vae import VAE


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another; a CUDA device on a machine without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class LION(nn.Module):
    """`vae`, when given, is used as the model's VAE (a trainer's frozen
    stage-1 VAE) instead of a new one; it must sit on `device`."""

    def __init__(self, cfg, device="cuda", vae: Optional[VAE] = None):
        super().__init__()
        view = as_view(cfg)
        self.cfg = cfg
        with resolve_device(device):
            self.vae = VAE(cfg) if vae is None else vae
            self.global_prior = build_global_prior(view)
            self.local_prior = build_local_prior(view)
        self.diffusion = DiffusionDiscretized(view)
        self.mixed_prediction = bool(view.sde.mixed_prediction)
        self.num_points = view.data.tr_max_sample_points
        self.style_dim = view.latent_pts.style_dim
        self.point_channels = view.shapelatent.latent_dim + view.ddpm.input_dim
        self.local_dim = self.num_points * self.point_channels
        self.cond_on_cat = bool(view.data.cond_on_cat)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def init_params(self, generator: torch.Generator) -> "LION":
        """Draw every parameter with the JAX package's initializers."""
        init_weights(self, generator)
        return self

    def load_jax_params(self, tree) -> "LION":
        """Load LION's whole JAX param tree ({'vae', 'global_prior',
        'local_prior'} nested dicts of numpy arrays), strictly."""
        self.load_state_dict(state_dict_from_jax(tree), strict=True)
        return self

    def class_condition(self, class_label) -> torch.Tensor:
        """(B,) int labels or (B, nclass) one-hot rows -> the frozen VAE's
        class embedding (B, tpu.cls_emb_dim) (cond_on_cat runs)."""
        return self.vae.embed_class(class_label)

    @torch.no_grad()
    def sample(self, num_samples: int = 10,
               generator: Optional[torch.Generator] = None,
               given_noise=None, ddim_step: int = 0, class_label=None,
               clip_feat=None) -> dict:
        """Hierarchical sampling: the PF-ODE under cfg.sde.ode_sample,
        else ancestral DDPM, or DDIM with `ddim_step` steps when it is
        above 0 (which the PF-ODE refuses, as the JAX package does).

        `given_noise`: optional ((init_g, steps_g), (init_l, steps_l)) with
        init (B, D) and steps (T, B, D) tensors replacing every Gaussian
        draw of the two ancestral chains (lion_tpu's given_noise); under
        the PF-ODE the steps are None and the inits are the ODE's starting
        points (lion_tpu's `sample_model_ode(noise=)`). Returns z_global
        (B, style), z_local (B, N*C), points (B, N, 3), the wall seconds of
        each stage (`stage_seconds`: "global", "local" and "decode", the
        host seconds of the spans `sample.global`, `sample.local` and
        `sample.decode` of `utils.spans`, each closed after a device sync)
        and under the PF-ODE the function evaluations of both priors
        (`nfe`) and of each (`nfe_global`, `nfe_local`). `class_label`
        (cond_on_cat) and `clip_feat` (clipforge.enable) condition the
        sample."""
        use_ode = bool(self.cfg.sde.ode_sample)
        if use_ode and ddim_step > 0:
            raise ValueError("ode_sample and ddim_step are exclusive")
        if given_noise is not None:
            if ddim_step > 0:
                raise ValueError("given_noise is only defined for the "
                                 "ancestral DDPM branch (ddim_step = 0) and "
                                 "the PF-ODE's starting points")
            if use_ode and any(steps is not None
                               for _, steps in given_noise):
                raise ValueError("the PF-ODE draws no step noise: give "
                                 "((init_g, None), (init_l, None))")
        return self._sample(num_samples, generator, given_noise, chunks=1,
                            ddim_step=ddim_step, ode=use_ode,
                            class_label=class_label, clip_feat=clip_feat)

    @torch.no_grad()
    def sample_chunked(self, num_samples: int,
                       generator: Optional[torch.Generator] = None,
                       chunks: int = 4, given_noise=None, class_label=None,
                       clip_feat=None, group=None) -> dict:
        """`sample` with each chain run as `chunks` equal segments (the JAX
        package splits its device programs so; here the segments run back
        to back and give the same samples as `sample`, `given_noise`
        included). It runs the ancestral chain under cfg.sde.ode_sample
        too, as the JAX package's does.

        `group`: a torch.distributed process group (the default one:
        `torch.distributed.group.WORLD`) whose size divides num_samples.
        Rank r samples rows [r n, (r + 1) n) of n = num_samples / size:
        its rows of every `given_noise` draw, label and CLIP feature;
        without given noise, a generator seeded by a draw from `generator`
        plus the rank. Every rank returns all rows in rank order."""
        if self.diffusion.num_steps % chunks:
            raise ValueError(f"chunks ({chunks}) must divide ddpm.num_steps "
                             f"({self.diffusion.num_steps})")
        if group is None:
            return self._sample(num_samples, generator, given_noise, chunks,
                                class_label=class_label, clip_feat=clip_feat)
        import torch.distributed as dist
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if num_samples % size:
            raise ValueError(f"num_samples ({num_samples}) must divide over "
                             f"the group's {size} ranks")
        n = num_samples // size
        rows = slice(rank * n, (rank + 1) * n)
        if given_noise is not None:
            given_noise = tuple(
                (None if init is None else init[rows],
                 None if steps is None else steps[:, rows])
                for init, steps in given_noise)
        else:
            dev = self.device
            gen = generator if generator is not None else \
                torch.Generator(device=dev).manual_seed(0)
            base = int(torch.randint(2 ** 62, (1,), generator=gen,
                                     device=gen.device))
            generator = torch.Generator(device=dev).manual_seed(base + rank)
        if class_label is not None:
            class_label = torch.as_tensor(class_label)[rows]
        if clip_feat is not None:
            clip_feat = torch.as_tensor(clip_feat)[rows]
        out = self._sample(n, generator, given_noise, chunks,
                           class_label=class_label, clip_feat=clip_feat)
        for k in ("z_global", "z_local", "points"):
            out[k] = gather_rows(out[k], group)
        return out

    def _chain(self, model_fn, x, generator, mixing_logit, given_noise,
               chunks: int, ddim_step: int = 0):
        if ddim_step > 0:
            sde = self.cfg.sde
            return self.diffusion.run_ddim(
                model_fn, x.shape[0], x.shape[1:], ddim_step,
                skip_type=sde.ddim_skip_type, kappa=float(sde.ddim_kappa),
                generator=generator, mixing_logit=mixing_logit, x_noisy=x)
        ts = range(self.diffusion.num_steps - 1, -1, -1)
        seg = len(ts) // chunks
        for i in range(chunks):
            x = self.diffusion._denoise_ts(
                model_fn, x, ts[i * seg:(i + 1) * seg], generator,
                mixing_logit=mixing_logit, given_noise=given_noise)
        return x

    def _ode(self, model_fn, x, mixing_logit):
        """The PF-ODE from x (t = 1) to t = ode_eps (dopri5 at
        ode_solver_tol) -> (x_0, nfe)."""
        sde = as_view(self.cfg).sde
        return make_diffusion(sde).sample_model_ode(
            model_fn, x.shape[0], x.shape[1:], ode_eps=float(sde.ode_eps),
            ode_solver_tol=float(sde.ode_solver_tol), noise=x,
            mixing_logit=mixing_logit)

    def condition_inputs(self, num_samples, class_label=None,
                         clip_feat=None, ode: bool = False):
        """The class embedding (or None) and the CLIP features on the
        model's device (or None), checked against the config: labels
        under data.cond_on_cat and not for the PF-ODE (`ode`), features
        under clipforge.enable."""
        dev = self.device
        cls_emb = None
        if self.cond_on_cat:
            if class_label is None:
                raise ValueError("data.cond_on_cat: the priors need "
                                 "class_label")
            if ode:
                raise ValueError(
                    "the PF-ODE takes no class labels (lion_tpu/models/"
                    "lion.py:248; the reference's assert, "
                    "train_2prior.py:67)")
            cls_emb = self.class_condition(class_label)
        elif class_label is not None:
            raise ValueError("class_label needs data.cond_on_cat")
        if clip_feat is not None:
            if not self.cfg.clipforge.enable:
                raise ValueError("clip_feat needs clipforge.enable")
            clip_feat = torch.as_tensor(clip_feat, dtype=torch.float32,
                                        device=dev)
            if clip_feat.shape[0] != num_samples:
                raise ValueError(f"clip_feat {tuple(clip_feat.shape)} for "
                                 f"{num_samples} samples")
        return cls_emb, clip_feat

    def _sample(self, num_samples, generator, given_noise, chunks,
                ddim_step=0, ode=False, class_label=None, clip_feat=None):
        with span("sample"):
            self.eval()
            dev = self.device
            cls_emb, clip_feat = self.condition_inputs(
                num_samples, class_label, clip_feat, ode)
            global_fn = lambda xx, t: self.global_prior(  # noqa: E731
                xx, t, clip_feat=clip_feat)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            (x_g, noise_g), (x_l, noise_l) = given_noise or (
                (None, None), (None, None))
            mix_g = self.global_prior.mixing_logit \
                if self.mixed_prediction else None
            mix_l = self.local_prior.mixing_logit \
                if self.mixed_prediction else None
            nfe = {}

            with span("sample.global") as st_global:
                shape_g = (num_samples, self.style_dim)
                x = randn(shape_g, generator, dev) if x_g is None \
                    else x_g.reshape(shape_g).to(dev)
                if ode:
                    z_global, nfe["nfe_global"] = self._ode(global_fn, x,
                                                            mix_g)
                else:
                    z_global = self._chain(global_fn, x, generator, mix_g,
                                           noise_g, chunks, ddim_step)
                _sync(dev)

            with span("sample.local") as st_local:
                shape_l = (num_samples, self.num_points, self.point_channels)
                x = randn(shape_l, generator, dev) if x_l is None \
                    else x_l.reshape(shape_l).to(dev)
                condition = z_global if cls_emb is None else \
                    torch.cat([z_global, cls_emb], dim=1)
                local_fn = lambda xx, t: self.local_prior(  # noqa: E731
                    xx, t, condition_input=condition, clip_feat=clip_feat)
                if ode:
                    z_local, nfe["nfe_local"] = self._ode(local_fn, x, mix_l)
                    nfe["nfe"] = nfe["nfe_global"] + nfe["nfe_local"]
                else:
                    z_local = self._chain(local_fn, x, generator, mix_l,
                                          noise_l, chunks, ddim_step)
                z_local = z_local.reshape(num_samples, self.local_dim)
                _sync(dev)

            with span("sample.decode") as st_decode:
                points = self.vae.sample(num_samples, [z_global, z_local],
                                         class_label=class_label)
                _sync(dev)
            seconds = {"global": st_global.seconds,
                       "local": st_local.seconds,
                       "decode": st_decode.seconds}
            return {"z_global": z_global, "z_local": z_local,
                    "points": points, "stage_seconds": seconds, **nfe}
