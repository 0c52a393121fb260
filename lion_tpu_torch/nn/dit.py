"""The layers of DiT-3D (github.com/DiT-3D/DiT-3D `models/dit3d.py` and
`models/dit3d_window_attn.py`, whose blocks are DiT's, facebookresearch/DiT
`models.py`): the timestep and label embedders, the 3-D sin-cos position
table, the patch embedding and its inverse, the DiT block with adaLN-Zero
and its 3-D window partition, and the final layer. Parameter names are
DiT-3D's, so a state dict moves between the two.

Tokens are a cloud's voxel patches in (x, y, z) order, (B, T, D). The
attention is `ops.attention` (fused, forward and backward); a windowed
block cuts the modulated tokens into w^3-token windows put on the batch
axis (one permuted copy) and puts them back after the projection. The
patch embedding (DiT-3D's Conv3d of kernel = stride = p) is one GEMM over
the grid's patches, which the channels-last grid of K3 gives by a view
and one permuted copy.

Spans (`utils.spans`): `dit.attn.global` or `dit.attn.window` around each
attention (its qkv and projection, and the window partition), `dit.mlp`
around each MLP.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..utils.spans import span


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """(M, dim) float64: sin | cos of pos times 1 / 10000^(2i / dim)."""
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                            / (dim / 2.0))
    out = pos.reshape(-1).astype(np.float64)[:, None] * omega[None]
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d(dim: int, grid: int) -> torch.Tensor:
    """The frozen position table (grid^3, dim) float32: dim / 3 channels for
    each axis of the token's (x, y, z), tokens in (x, y, z) order."""
    if dim % 6:
        raise ValueError(f"sincos_3d: the width {dim} is not a multiple "
                         f"of 6")
    axis = np.arange(grid, dtype=np.float32)
    g = np.meshgrid(axis, axis, axis, indexing="ij")
    return torch.from_numpy(np.concatenate(
        [sincos_1d(dim // 3, g[i]) for i in range(3)], axis=1)).float()


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """(B, dim): cos | sin of t times exp(-ln(max_period) i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without an affine, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def window_partition(x: torch.Tensor, grid: int, w: int) -> torch.Tensor:
    """(B, grid^3, C) -> (B (grid / w)^3, w^3, C): the w x w x w windows of
    the token grid on the batch axis, each window's tokens in (x, y, z)
    order."""
    if grid % w:
        raise ValueError(f"window_partition: {w} does not divide {grid}")
    b, _, c = x.shape
    n = grid // w
    x = x.view(b, n, w, n, w, n, w, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * n ** 3, w ** 3, c)


def window_unpartition(x: torch.Tensor, grid: int, w: int) -> torch.Tensor:
    """The inverse of `window_partition`."""
    n = grid // w
    c = x.shape[-1]
    x = x.view(-1, n, n, n, w, w, w, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(-1, grid ** 3, c)


def patchify(grid: torch.Tensor, p: int) -> torch.Tensor:
    """(B, R, R, R, C) channels-last -> (B, (R / p)^3, C p^3), each patch's
    values in (c, px, py, pz) order, as a Conv3d weight (D, C, p, p, p)
    holds them."""
    b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
    g = r // p
    x = grid.view(b, g, p, g, p, g, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, g ** 3, c * p ** 3)


def unpatchify(x: torch.Tensor, r: int, p: int, c: int) -> torch.Tensor:
    """(B, (r / p)^3, p^3 c), each token's values in (px, py, pz, c) order
    (DiT-3D's `unpatchify_voxels`) -> the channels-last grid (B, r, r, r,
    c)."""
    b, g = x.shape[0], r // p
    x = x.view(b, g, g, g, p, p, p, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, r, r, r, c)


class PatchEmbed(nn.Module):
    """DiT-3D's `PatchEmbed_Voxel`: proj, a Conv3d(C, D, p, stride p),
    computed as one GEMM over the patches."""

    def __init__(self, p: int, channels: int, dim: int):
        super().__init__()
        self.p = p
        self.proj = nn.Conv3d(channels, dim, kernel_size=p, stride=p)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight
        return F.linear(patchify(grid, self.p), w.view(w.shape[0], -1),
                        self.proj.bias)


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, freq: int = 256):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(nn.Linear(freq, dim), nn.SiLU(),
                                 nn.Linear(dim, dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(timestep_embedding(t, self.freq))


class LabelEmbedder(nn.Module):
    """num_classes rows and the null row (classifier-free guidance's
    dropped label)."""

    def __init__(self, num_classes: int, dim: int):
        super().__init__()
        self.num_classes = num_classes
        self.embedding_table = nn.Embedding(num_classes + 1, dim)

    def forward(self, y: torch.Tensor,
                drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        if drop is not None:
            y = torch.where(drop, self.num_classes, y)
        return self.embedding_table(y)


class Attention(nn.Module):
    """timm's attention as DiT builds it (qkv with bias, proj), on the
    fused kernel; `tf32` runs its products in TF32 (the check's
    control)."""

    def __init__(self, dim: int, heads: int, tf32: bool = False):
        super().__init__()
        self.heads, self.tf32 = heads, tf32
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, c = x.shape
        qkv = self.qkv(x).view(n, length, 3, self.heads, c // self.heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        o = attention(q, k, v, tf32=self.tf32)
        return self.proj(o.transpose(1, 2).reshape(n, length, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """A DiT block with adaLN-Zero; `window` > 0 makes its attention
    attend within window^3-token windows of the (grid^3)-token cloud."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, grid: int,
                 window: int = 0, tf32: bool = False):
        super().__init__()
        self.grid, self.window = grid, window
        self.attn = Attention(dim, heads, tf32)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(dim, 6 * dim))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=1)
        h = modulate(layer_norm(x), shift_msa, scale_msa)
        if self.window:
            with span("dit.attn.window"):
                h = window_unpartition(self.attn(window_partition(
                    h, self.grid, self.window)), self.grid, self.window)
        else:
            with span("dit.attn.global"):
                h = self.attn(h)
        x = x + gate_msa[:, None] * h
        h = modulate(layer_norm(x), shift_mlp, scale_mlp)
        with span("dit.mlp"):
            h = self.mlp(h)
        return x + gate_mlp[:, None] * h


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = nn.Linear(dim, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(dim, 2 * dim))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(layer_norm(x), shift, scale))
