"""Common building blocks (port of lion_tpu/nn/common.py).

Channels-last everywhere: points (B, N, C), grids (B, R, R, R, C). Parameter
names and layouts follow the flax tree of the JAX package, so its params
load with a flatten (ckpt/from_jax.py):
  Dense kernel (in, out) and bias (out,);
  Conv3dSame kernel (3, 3, 3, in, out) and bias (out,);
  GroupNorm affine scale/bias (C,);
  RandomFourierEmbedding w (1, embedding_dim // 2).

Parameters start empty; `init_weights(module, generator)` draws them with
the JAX package's initializers (torch nn.Linear's default uniform for Dense
and Conv, a fan-avg uniform for the AdaGN style projection) on the
generator's device, so one generator gives the same weights on any device.

Train mode is `self.training`. `Dropout` draws its masks from a generator
that the caller sets (`set_dropout_generator`), never from the global RNG.
`Conv3dSame` has the fused eval call (no gradient) and the modular call
(`modular`, the training conv with its gradient, in float32 or bf16).

Compute dtype: modules built with `dtype=torch.bfloat16` compute in bf16
while their parameters stay fp32, as the JAX package's `dtype` does. Dense
layers cast their kernel and bias to the dtype at use; GroupNorm and AdaGN
compute in fp32 and SharedMLP rounds norm + swish once to its dtype;
LinearAttention runs its softmax in fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

import torch
from torch import nn

from ..ops.conv3d import (GN_EPS, GN_GROUPS, conv3d_3x3_fused,
                          conv3d_3x3_same, gn_affine_from_stats)


def swish(x):
    return x * torch.sigmoid(x)


def _uniform(p: torch.Tensor, bound: float, generator) -> None:
    draw = torch.empty(p.shape, device=generator.device)
    with torch.no_grad():
        p.copy_(draw.uniform_(-bound, bound, generator=generator))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` with its JAX-package initializer."""
    for m in module.modules():
        fn = getattr(m, "init_own_weights", None)
        if fn is not None:
            fn(generator)


class TDense(nn.Module):
    """Dense layer with torch nn.Linear's default init: kernel and bias
    ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)). `dtype` is the compute dtype;
    None computes in the promoted dtype of the input and the fp32 kernel,
    as flax's nn.Dense does."""

    def __init__(self, features: int, fan_in: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fan_in = fan_in
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def init_own_weights(self, generator):
        bound = 1.0 / math.sqrt(self.fan_in)
        _uniform(self.kernel, bound, generator)
        if self.bias is not None:
            _uniform(self.bias, bound, generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv3dSame(nn.Module):
    """3x3x3 SAME conv (NDHWC) with torch nn.Conv3d's default init: the
    fused eval call of the JAX module (`fused=True`, `forward`) and its
    training call (`modular`)."""

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
        the conv bias, in x's dtype (the kernel is cast to it), stats
        (B, 2, C) = per-channel (sum, sumsq) of y_raw; the caller folds bias
        into the next norm."""
        sc, bi = (None, None) if in_affine is None else in_affine
        y, st = conv3d_3x3_fused(x.contiguous(),
                                 self.kernel.detach().to(x.dtype),
                                 None if sc is None else sc.contiguous(),
                                 None if bi is None else bi.contiguous(),
                                 pre_swish=pre_swish)
        return y, st, self.bias

    def modular(self, x, dtype: Optional[torch.dtype] = None):
        """conv3d_3x3_same(x, kernel) + bias with gradients, in `dtype`
        (None: x's): x and the kernel cast to it, the bias added in the
        output's dtype (lion_tpu/nn/common.py:101, 129-136)."""
        dt = dtype or x.dtype
        y = conv3d_3x3_same(x.to(dt), self.kernel.to(dt))
        return y + self.bias.to(y.dtype)


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


def group_norm(x, scale, bias, groups: int = GN_GROUPS, eps: float = GN_EPS):
    """GroupNorm over (B, ..., C) as flax computes it: `groups` groups
    (8 by default), statistics over all non-batch dims of each group,
    var = E[x^2] - E[x]^2 clamped at 0, `eps` (1e-5 by default). Computed
    and returned in fp32 whatever x's dtype. The two means are accumulated
    in float64: PyTorch's CPU reduction over the point axis adds its up to
    10^5 terms one after another, whose float32 rounding reached 1e-3 of a
    normalized output at 1024 centers x 32 slots."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True, dtype=torch.float64)
    var = torch.clamp_min(
        (xg * xg).mean(dim=(1, 3), keepdim=True, dtype=torch.float64)
        - mean * mean, 0.0)
    mean, var = mean.float(), var.float()
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale + bias


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
        """AdaGN(x) in fp32."""
        factor, bias = self._style(style)
        out = group_norm(x, self.norm.scale, self.norm.bias)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (self.n_channel,)
        return out * factor.reshape(shape) + bias.reshape(shape)

    def channel_affine(self, style):
        """The post-norm (ca, cb) (B, C) with AdaGN(x) == GN0(x) * ca + cb,
        GN0 the parameter-free GroupNorm."""
        factor, bias = self._style(style)
        return self.norm.scale * factor, self.norm.bias * factor + bias


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
        """The norm of x, in fp32."""
        if self.is_ada:
            return self.ada(x, style)
        return group_norm(x, self.gn.scale, self.gn.bias)

    def channel_affine(self, style, batch: int):
        """The post-norm channel affine (ca, cb) (batch, C) with
        Norm(x) == GN0(x) * ca + cb (lion_tpu/nn/common.py:188-193,302-304)."""
        if self.is_ada:
            return self.ada.channel_affine(style)
        c = self.gn.scale.shape[0]
        return (self.gn.scale[None].expand(batch, c),
                self.gn.bias[None].expand(batch, c))

    def fold(self, style, stats, count, conv_bias=None):
        """Per-channel (scale, bias) (B, C) of this norm over a raw tensor
        whose (sum, sumsq) are `stats` (B, 2, C), with the conv bias added
        before the norm."""
        ca, cb = self.channel_affine(style, stats.shape[0])
        return gn_affine_from_stats(stats[:, 0], stats[:, 1], count, ca, cb,
                                    pre_bias=conv_bias)


class SE(nn.Module):
    """Squeeze-excite. The eval flow only needs its gate: PVConv derives the
    pooled means from conv statistics and folds the gate into an affine;
    the training flow pools and applies it (`forward`)."""

    def __init__(self, channel: int):
        super().__init__()
        self.fc1 = TDense(channel // 8, channel, use_bias=False)
        self.fc2 = TDense(channel, channel // 8, use_bias=False)

    def gate(self, pooled):
        """(B, C) pooled means -> (B, C) gate."""
        return torch.sigmoid(self.fc2(torch.relu(self.fc1(pooled))))

    def forward(self, x):
        """x (B, ..., C) -> x * gate(mean of x over its middle dims)."""
        gate = self.gate(x.mean(dim=tuple(range(1, x.ndim - 1))))
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return x * gate.reshape(shape).to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator):
    """nn.Dropout's semantics with the mask drawn from `generator` (on x's
    device): keep each element with probability 1 - p and divide the kept
    ones by 1 - p, as flax computes it."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dropout(nn.Module):
    """`dropout` in train mode with the generator in `self.generator`
    (`set_dropout_generator`); the identity in eval mode or at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator "
                               "(set_dropout_generator)")
        return dropout(x, self.p, self.generator)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Give every Dropout under `module` the generator its masks come from."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class LinearAttention(nn.Module):
    """softmax(k) @ v attention over the point axis, O(N d^2); the softmax
    runs in fp32."""

    def __init__(self, dim: int, heads: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dim_head = 32
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = TDense(heads * dim_head * 3, dim, use_bias=False,
                             dtype=dtype)
        self.to_out = TDense(dim, heads * dim_head, dtype=dtype)

    def forward(self, x):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.to_qkv(x).reshape(b, n, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (B, N, h, d)
        k = torch.softmax(k.float(), dim=1).to(k.dtype)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return self.to_out(out.reshape(b, n, h * d))


class SharedMLP(nn.Module):
    """Per-point MLP: [Dense -> (Ada)GN(8) -> swish] x len(out_channels),
    on (B, N, C) or (B, M, K, C). The norm and swish run in fp32 and the
    result is rounded once to the dense layer's dtype."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth = len(out_channels)
        cin = in_channels
        for i, oc in enumerate(out_channels):
            self.add_module(f"conv{i}", TDense(oc, cin, dtype=dtype))
            self.add_module(f"norm{i}",
                            Normalizer(oc, ada, style_dim, init_scale))
            cin = oc
        self.out_channels = cin

    def forward(self, x, style=None):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
            x = swish(getattr(self, f"norm{i}")(x, style)).to(x.dtype)
        return x

    def fold(self, style, batch: int):
        """Fold mode for fused-kernel consumers (lion_tpu/nn/common.py:
        384-400): per layer (kernel (Cin, C), bias (C,), ca, cb (batch, C))
        with layer(x) == swish(GN0(x @ kernel + bias) * ca + cb)."""
        layers = []
        for i in range(self.depth):
            dense = getattr(self, f"conv{i}")
            ca, cb = getattr(self, f"norm{i}").channel_affine(style, batch)
            layers.append((dense.kernel, dense.bias, ca, cb))
        return layers


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


class RandomFourierEmbedding(nn.Module):
    """The random-Fourier time embedding (B,) -> (B, embedding_dim):
    [sin(t w 2 pi), cos(t w 2 pi)] with w (1, embedding_dim // 2) drawn
    N(0, scale^2) once. w is a parameter that gets no gradient (the JAX
    package stops it), so the optimizer sees a zero gradient for it."""

    def __init__(self, embedding_dim: int, scale: float):
        super().__init__()
        self.scale = float(scale)
        self.w = nn.Parameter(torch.empty(1, embedding_dim // 2))

    def init_own_weights(self, generator):
        draw = torch.empty(self.w.shape, device=generator.device)
        with torch.no_grad():
            self.w.copy_(draw.normal_(generator=generator) * self.scale)

    def forward(self, timesteps):
        w = self.w.detach()
        emb = timesteps.float()[:, None] \
            * (w[0] * (2.0 * 3.14159265359))[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def compute_dtype(cfg) -> Optional[torch.dtype]:
    """The U-Nets' compute dtype: bf16 when cfg.tpu.bf16 is set, else None
    (fp32), as lion_tpu/models/priors.py:231 and vae.py:60 pick it."""
    return torch.bfloat16 if ("tpu" in cfg and cfg.tpu.bf16) else None


__all__ = ["swish", "init_weights", "TDense", "Conv3dSame", "GNAffine",
           "group_norm", "gn_affine_from_stats", "AdaGN", "Normalizer", "SE",
           "dropout", "Dropout", "set_dropout_generator", "LinearAttention",
           "SharedMLP", "timestep_embedding", "RandomFourierEmbedding",
           "compute_dtype"]
