"""Common building blocks (port of lion_tpu/nn/common.py).

Channels-last everywhere: points (B, N, C), grids (B, R, R, R, C). Parameter
names and layouts follow the flax tree of the JAX package, so its params
load with a flatten (ckpt/from_jax.py):
  Dense kernel (in, out) and bias (out,);
  Conv3dSame kernel (3, 3, 3, in, out) and bias (out,);
  GroupNorm affine scale/bias (C,).

Parameters start empty; `init_weights(module, generator)` draws them with
the JAX package's initializers (torch nn.Linear's default uniform for Dense
and Conv, a fan-avg uniform for the AdaGN style projection).
Inference only: no dropout, no gradient through the fused conv.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

import torch
from torch import nn

from ..ops.conv3d import conv3d_3x3_fused


def swish(x):
    return x * torch.sigmoid(x)


def _uniform(p: torch.Tensor, bound: float, generator) -> None:
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` with its JAX-package initializer."""
    for m in module.modules():
        fn = getattr(m, "init_own_weights", None)
        if fn is not None:
            fn(generator)


class TDense(nn.Module):
    """Dense layer with torch nn.Linear's default init: kernel and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, features: int, fan_in: int, use_bias: bool = True):
        super().__init__()
        self.fan_in = fan_in
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_own_weights(self, generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform(self.kernel, bound, generator)
        if self.bias is not None:
            _uniform(self.bias, bound, generator)

    def forward(self, x):
        y = torch.matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


class Conv3dSame(nn.Module):
    """3x3x3 SAME conv (NDHWC) with torch nn.Conv3d's default init; only the
    fused eval call of the JAX module (`fused=True`) is ported."""

    def __init__(self, features: int, fan_in_channels: int):
        super().__init__()
        self.fan_in = fan_in_channels * 27
        self.kernel = nn.Parameter(
            torch.empty(3, 3, 3, fan_in_channels, features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_own_weights(self, generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform(self.kernel, bound, generator)
        _uniform(self.bias, bound, generator)

    def forward(self, x, in_affine=None, pre_swish: bool = False):
        """Returns (y_raw, stats, bias): y_raw = conv(swish?(x*s + b)) WITHOUT
        the conv bias, stats (B, 2, C) = per-channel (sum, sumsq) of y_raw;
        the caller folds bias into the next norm."""
        sc, bi = (None, None) if in_affine is None else in_affine
        y, st = conv3d_3x3_fused(x.contiguous(), self.kernel.detach(),
                                 None if sc is None else sc.contiguous(),
                                 None if bi is None else bi.contiguous(),
                                 pre_swish=pre_swish)
        return y, st, self.bias


class GNAffine(nn.Module):
    """Bare GroupNorm affine params: scale = 1, bias = 0 at init."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def init_own_weights(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()


GN_GROUPS, GN_EPS = 8, 1e-5


def group_norm(x, scale, bias):
    """GroupNorm(8) over (B, ..., C) as flax computes it: statistics over
    all non-batch dims of each group, var = E[x^2] - E[x]^2 clamped at 0."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, GN_GROUPS, c // GN_GROUPS)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp_min((xg * xg).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, 0.0)
    y = ((xg - mean) * torch.rsqrt(var + GN_EPS)).reshape(x.shape)
    return y * scale + bias


def gn_affine_from_stats(s1, s2, count, gn_scale, gn_bias, pre_bias=None):
    """Fold GroupNorm(8) into per-channel (scale, bias) from raw statistics.

    s1/s2 (B, C): per-channel sum and sum of squares of the raw tensor y
    over `count` spatial elements; pre_bias (C,) is added to y before the
    norm (the conv bias). Returns (scale, bias) (B, C) with
    GN(y + pre_bias) == scale * y + bias."""
    b, c = s1.shape
    mean_c = s1 / count
    ex2_c = s2 / count
    if pre_bias is not None:
        # E[(y+b)^2] = E[y^2] + 2 b E[y] + b^2
        ex2_c = ex2_c + 2.0 * pre_bias[None, :] * mean_c + pre_bias[None, :] ** 2
        mean_c = mean_c + pre_bias[None, :]
    per = c // GN_GROUPS
    gmean = mean_c.reshape(b, GN_GROUPS, per).mean(dim=2)
    gex2 = ex2_c.reshape(b, GN_GROUPS, per).mean(dim=2)
    gvar = torch.clamp_min(gex2 - gmean ** 2, 0.0)
    rs_c = torch.rsqrt(gvar + GN_EPS).repeat_interleave(per, dim=1)
    mu_c = gmean.repeat_interleave(per, dim=1)
    scale = rs_c * gn_scale[None, :]
    bias = gn_bias[None, :] - mu_c * scale
    if pre_bias is not None:
        bias = bias + pre_bias[None, :] * scale
    return scale, bias


class _StyleDense(TDense):
    """AdaGN's style projection: variance-scaling (fan_avg, uniform) kernel,
    bias (1, ..., 1, 0, ..., 0) so the layer starts as the identity."""

    def __init__(self, n_channel: int, style_dim: int, init_scale: float):
        super().__init__(2 * n_channel, style_dim)
        self.n_channel = n_channel
        self.init_scale = 1e-10 if init_scale == 0 else init_scale

    def init_own_weights(self, generator):
        fan_avg = (self.kernel.shape[0] + self.kernel.shape[1]) / 2.0
        _uniform(self.kernel, math.sqrt(3.0 * self.init_scale / fan_avg),
                 generator)
        with torch.no_grad():
            self.bias.zero_()
            self.bias[:self.n_channel] = 1.0


class AdaGN(nn.Module):
    """Adaptive GroupNorm: GroupNorm(8, C), then a per-channel (factor,
    bias) projected from the style vector."""

    def __init__(self, n_channel: int, style_dim: int = 128,
                 init_scale: float = 1.0):
        super().__init__()
        self.n_channel = n_channel
        self.emd = _StyleDense(n_channel, style_dim, init_scale)
        self.norm = GNAffine(n_channel)

    def _style(self, style):
        s = self.emd(style.float())
        return s[:, :self.n_channel], s[:, self.n_channel:]

    def forward(self, x, style):
        factor, bias = self._style(style)
        out = group_norm(x, self.norm.scale, self.norm.bias)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (self.n_channel,)
        return out * factor.reshape(shape) + bias.reshape(shape)

    def fold(self, style, stats, count, conv_bias=None):
        """Per-channel (scale, bias) (B, C) of this norm over a raw tensor
        whose (sum, sumsq) are `stats` (B, 2, C)."""
        factor, bias = self._style(style)
        sc, bi = gn_affine_from_stats(stats[:, 0], stats[:, 1], count,
                                      self.norm.scale, self.norm.bias,
                                      pre_bias=conv_bias)
        return sc * factor, bi * factor + bias


class Normalizer(nn.Module):
    """GroupNorm(8) or AdaGN, picked by `ada`."""

    def __init__(self, n_channel: int, ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0):
        super().__init__()
        self.is_ada = ada
        if ada:
            self.ada = AdaGN(n_channel, style_dim, init_scale)
        else:
            self.gn = GNAffine(n_channel)

    def forward(self, x, style=None):
        if self.is_ada:
            return self.ada(x, style)
        return group_norm(x, self.gn.scale, self.gn.bias)

    def fold(self, style, stats, count, conv_bias=None):
        if self.is_ada:
            return self.ada.fold(style, stats, count, conv_bias)
        return gn_affine_from_stats(stats[:, 0], stats[:, 1], count,
                                    self.gn.scale, self.gn.bias,
                                    pre_bias=conv_bias)


class SE(nn.Module):
    """Squeeze-excite. The eval flow only needs its gate: PVConv derives the
    pooled means from conv statistics and folds the gate into an affine."""

    def __init__(self, channel: int):
        super().__init__()
        self.fc1 = TDense(channel // 8, channel, use_bias=False)
        self.fc2 = TDense(channel, channel // 8, use_bias=False)

    def gate(self, pooled):
        """(B, C) pooled means -> (B, C) gate."""
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))


class LinearAttention(nn.Module):
    """softmax(k) @ v attention over the point axis, O(N d^2)."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        dim_head = 32
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = TDense(heads * dim_head * 3, dim, use_bias=False)
        self.to_out = TDense(dim, heads * dim_head)

    def forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, n, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (B, N, h, d)
        k = torch.softmax(k, dim=1)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return self.to_out(out.reshape(b, n, h * d))


class SharedMLP(nn.Module):
    """Per-point MLP: [Dense -> (Ada)GN(8) -> swish] x len(out_channels),
    on (B, N, C) or (B, M, K, C)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0):
        super().__init__()
        self.depth = len(out_channels)
        cin = in_channels
        for i, oc in enumerate(out_channels):
            self.add_module(f"conv{i}", TDense(oc, cin))
            self.add_module(f"norm{i}",
                            Normalizer(oc, ada, style_dim, init_scale))
            cin = oc
        self.out_channels = cin

    def forward(self, x, style=None):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
            x = swish(getattr(self, f"norm{i}")(x, style))
        return x


def timestep_embedding(timesteps: torch.Tensor, embed_dim: int,
                       scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal embedding (B,) -> (B, embed_dim)."""
    timesteps = timesteps.float() * scale
    half = embed_dim // 2
    # the exponent step in fp32, as the JAX form computes it
    step = float(-np.log(np.float32(10000.0)) / np.float32(half - 1))
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=timesteps.device) * step)
    args = timesteps[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if embed_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def require_fp32(cfg) -> None:
    """The port runs fp32 only."""
    if "tpu" in cfg and cfg.tpu.bf16:
        raise NotImplementedError("lion_tpu_torch runs fp32 only "
                                  "(tpu.bf16 = True is a later port)")


__all__ = ["swish", "init_weights", "TDense", "Conv3dSame", "GNAffine",
           "group_norm", "gn_affine_from_stats", "AdaGN", "Normalizer", "SE",
           "LinearAttention", "SharedMLP", "timestep_embedding",
           "require_fp32"]
