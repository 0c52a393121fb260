"""DiT-3D (Mo et al., "DiT-3D: Exploring Plain Diffusion Transformers for
3D Shape Generation", NeurIPS 2023; github.com/DiT-3D/DiT-3D
`models/dit3d_window_attn.py`): a plain diffusion transformer that
predicts the noise of a point cloud from its voxel patches.

    DiT3D(cfg, device="cuda")(x, t, y, drop) -> eps

x (B, N, 3) the noisy points, t (B,) the timestep index 0..T-1, y (B,)
the class label (zeros when None), drop (B,) bool the labels replaced by
the null row (classifier-free guidance's dropout; none when None). The
pass, under the spans of `utils.spans`:

  `dit.embed`   K3 voxelizes the points' own coordinates into a
                (B, r, r, r, 3) grid (`ops.voxelize`, PVCNN's normalized
                coordinates), the patch GEMM (DiT-3D's Conv3d of kernel =
                stride = p) gives (B, (r / p)^3, D), plus the frozen 3-D
                sin-cos table; the timestep and label embeddings give c
  blocks        `depth` DiT blocks with adaLN-Zero (`nn.dit.DiTBlock`), the
                ones in `dit3d.window_blocks` attending within 3-D windows
  `dit.final`   the final layer, unpatchify to (B, r, r, r, 3) and K5's
                trilinear devoxelization at the points

`sample` draws clouds through `diffusion.discrete` (DDIM, or the T-step
ancestral chain). The sampler hands the model t + 1 (1..T), the LION
convention; the model sees DiT-3D's t.

Every size comes from cfg.dit3d (`config.default`); float32 throughout,
the products in TF32 only under dit3d.tf32 (the benchmark's control).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config.view import as_view
from ..diffusion.discrete import DiffusionDiscretized
from ..nn.dit import (DiTBlock, FinalLayer, LabelEmbedder, PatchEmbed,
                      TimestepEmbedder, sincos_3d, unpatchify)
from ..ops._cuda import allow_tf32, no_tf32
from ..ops.voxel import trilinear_devoxelize, voxelize
from ..utils.spans import span
from .lion import resolve_device


class DiT3D(nn.Module):
    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        m = as_view(cfg).dit3d
        self.device = resolve_device(device)
        d, p, r = m.hidden_size, m.patch_size, m.voxel_size
        if r % p:
            raise ValueError(f"DiT3D: patch {p} does not divide voxel {r}")
        self.r, self.p, self.grid = r, p, r // p
        self.num_points = as_view(cfg).data.tr_max_sample_points
        self.tf32 = bool(m.tf32)
        windowed = set(m.window_blocks)
        with torch.device(self.device):
            self.x_embedder = PatchEmbed(p, 3, d)
            self.t_embedder = TimestepEmbedder(d, m.frequency_embedding_size)
            self.y_embedder = LabelEmbedder(m.num_classes, d)
            self.blocks = nn.ModuleList(
                DiTBlock(d, m.num_heads, m.mlp_ratio, self.grid,
                         m.window_size if i in windowed else 0, self.tf32)
                for i in range(m.depth))
            self.final_layer = FinalLayer(d, p ** 3 * 3)
        self.register_buffer("pos_embed", sincos_3d(d, self.grid)[None].to(
            self.device), persistent=False)
        self.diffusion = DiffusionDiscretized(as_view(cfg))

    def precision(self):
        """The products' precision: TF32 under dit3d.tf32, else full
        float32."""
        return allow_tf32() if self.tf32 else no_tf32()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "DiT3D":
        """DiT's initializer, tensor by tensor in parameter order, drawn
        from `generator` (on its device): biases zero; the embedders'
        weights, the adaLN layers' and the final linear's N(0, 0.02) (DiT
        zeroes the last two; here they are drawn so that a gradient
        reaches every block from the first step); every other weight,
        viewed as (out, in), xavier-uniform."""
        for name, param in self.named_parameters():
            if name.endswith("bias"):
                param.zero_()
                continue
            shape, gdev = param.shape, generator.device
            if name.startswith(("y_embedder", "t_embedder")) \
                    or "adaLN_modulation" in name \
                    or name.startswith("final_layer.linear"):
                val = 0.02 * torch.randn(shape, generator=generator,
                                         device=gdev)
            else:
                a = math.sqrt(6.0 / (shape[0] + math.prod(shape[1:])))
                val = (torch.rand(shape, generator=generator, device=gdev)
                       * 2.0 - 1.0) * a
            param.copy_(val)
        return self

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        if y is None:
            y = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        with span("dit.embed"):
            grid, coords = voxelize(x, x, self.r)
            h = self.x_embedder(grid) + self.pos_embed
            c = self.t_embedder(t) + self.y_embedder(y, drop)
        for block in self.blocks:
            h = block(h, c)
        with span("dit.final"):
            out = unpatchify(self.final_layer(h, c), self.r, self.p, 3)
            return trilinear_devoxelize(out, coords, self.r)

    @torch.no_grad()
    def sample(self, num_samples: int, generator=None,
               ddim_step: Optional[int] = None,
               class_label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(num_samples, N, 3) clouds in eval mode: DDIM over `ddim_step`
        steps (sde.ddim_skip_type, sde.ddim_kappa), or with ddim_step None
        or 0 the T-step ancestral chain; the start and every noise from
        `generator`. The span `sample`, each step `chain.prior` and
        `chain.update`."""
        cfg = as_view(self.cfg)
        self.eval()
        shape = (self.num_points, 3)

        def model_fn(x, timestep):
            return self(x, timestep - 1.0, class_label)

        with span("sample"), self.precision():
            if ddim_step:
                return self.diffusion.run_ddim(
                    model_fn, num_samples, shape, ddim_step,
                    cfg.sde.ddim_skip_type, cfg.sde.ddim_kappa,
                    generator=generator, device=self.device)
            return self.diffusion.run_denoising_diffusion(
                model_fn, num_samples, shape, generator=generator,
                device=self.device)
