"""PVCNN2 U-Net, channels-last and spec-driven (port of
lion_tpu/nn/unet.py).

The architecture is computed up front into declarative specs; a torch
module also needs every layer's input width when it is built, so the
constructor walks the same channel arithmetic the JAX module infers from
its inputs.

Reference quirks kept (load-bearing for checkpoint parity):
  * SA stages with index c > 0 build only ONE conv block regardless of
    num_blocks (pvcnn2_ada.py:484-489).
  * Conv attention fires at stages where (c+1) % 2 == 0 (and p == 0).
  * FP conv blocks never get attention.
  * The time embedding is concatenated to the features at SA stages i > 0
    and at every FP input; the first SA stage never sees it.
  * The last FP stage's skip input is only the extra (non-xyz) input
    channels (latent_points_ada.py:83,153).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from .common import LinearAttention, SharedMLP, TDense, timestep_embedding
from .pointnet import PointNetAModule, PointNetFPModule, PointNetSAModule
from .pvconv import PVConv


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    out_channels: int
    resolution: Optional[int]  # None -> SharedMLP instead of PVConv
    attention: bool


@dataclasses.dataclass(frozen=True)
class SASpec:
    num_centers: Optional[int]  # None -> PointNetAModule
    radius: Union[float, Tuple[float, ...]]
    num_neighbors: Union[int, Tuple[int, ...]]
    out_channels: tuple


@dataclasses.dataclass(frozen=True)
class SAStage:
    convs: Tuple[ConvSpec, ...]
    sa: Optional[SASpec]


@dataclasses.dataclass(frozen=True)
class FPStage:
    fp_out: Tuple[int, ...]
    convs: Tuple[ConvSpec, ...]


def build_sa_stages(sa_blocks, extra_feature_channels: int, input_dim: int = 3,
                    vres_mult: float = 1.0, ncenter_mult: float = 1.0):
    """Mirror of create_pointnet2_sa_components' channel arithmetic (with
    attention enabled, as both U-Nets of the model use it).

    Returns (stages, channels of the last SA output)."""
    in_channels = extra_feature_channels + input_dim
    stages = []
    for c, (conv_configs, sa_configs) in enumerate(sa_blocks):
        convs = []
        if conv_configs is not None:
            out_ch, num_blocks, vres = conv_configs
            for p in range(num_blocks):
                # reference quirk: for c > 0 only the first block exists
                if c == 0 or p == 0:
                    scaled_vres = vres if vres is None else \
                        max(int(vres * vres_mult), 2)
                    convs.append(ConvSpec(out_ch, scaled_vres,
                                          (c + 1) % 2 == 0 and p == 0))
                in_channels = out_ch
        sa = None
        if sa_configs is not None:
            num_centers, radius, num_neighbors, out_channels = sa_configs
            if num_centers is not None:
                num_centers = max(int(num_centers * ncenter_mult), 1)
            branches = out_channels if isinstance(out_channels[0],
                                                  (list, tuple)) \
                else [out_channels]
            sa = SASpec(num_centers, radius, num_neighbors,
                        tuple(tuple(br) for br in branches))
            in_channels = sum(br[-1] for br in branches)
        stages.append(SAStage(tuple(convs), sa))
    return stages, in_channels


def build_fp_stages(fp_blocks, vres_mult: float = 1.0):
    """Mirror of create_pointnet2_fp_modules' layer specs."""
    stages = []
    for fp_configs, conv_configs in fp_blocks:
        convs = []
        if conv_configs is not None:
            out_ch, num_blocks, vres = conv_configs
            scaled_vres = vres if vres is None else \
                max(int(vres * vres_mult), 2)
            convs = [ConvSpec(out_ch, scaled_vres, attention=False)] \
                * num_blocks
        stages.append(FPStage(tuple(fp_configs), tuple(convs)))
    return stages


class PVCNN2Unet(nn.Module):
    """SA encoder + global LinearAttention + FP decoder + classifier head,
    with an optional sinusoidal time embedding (embed_dim > 0) and AdaGN
    style conditioning threaded through every block (the AdaGN U-Nets of
    the local prior and the VAE decoder)."""

    def __init__(self, num_classes: int, sa_blocks, fp_blocks,
                 embed_dim: int = 0, extra_feature_channels: int = 3,
                 input_dim: int = 3, time_emb_scales: float = 1.0,
                 style_dim: int = 128, init_scale: float = 1.0,
                 vres_mult: float = 1.0, ncenter_mult: float = 1.0):
        super().__init__()
        self.input_dim = input_dim
        self.embed_dim = embed_dim
        self.time_emb_scales = time_emb_scales
        kw = dict(ada=True, style_dim=style_dim, init_scale=init_scale)
        if embed_dim > 0:
            self.embedf0 = TDense(embed_dim, embed_dim)
            self.embedf1 = TDense(embed_dim, embed_dim)

        self.sa_stages, channels_sa = build_sa_stages(
            sa_blocks, extra_feature_channels, input_dim,
            vres_mult=vres_mult, ncenter_mult=ncenter_mult)
        c = input_dim + extra_feature_channels
        skip_channels = []
        for i, stage in enumerate(self.sa_stages):
            skip_channels.append(c)
            if i > 0:
                c += embed_dim
            for j, spec in enumerate(stage.convs):
                self.add_module(f"sa{i}_conv{j}", self._conv(c, spec, kw))
                c = spec.out_channels
            if stage.sa is not None:
                s = stage.sa
                if s.num_centers is None:
                    mod = PointNetAModule(c, s.out_channels, **kw)
                else:
                    mod = PointNetSAModule(s.num_centers, s.radius,
                                           s.num_neighbors, c,
                                           s.out_channels, **kw)
                self.add_module(f"sa{i}_sa", mod)
                c = mod.out_channels
        # only the extra (non-coordinate) input channels feed the last FP
        skip_channels[0] = extra_feature_channels + input_dim - 3

        self.global_att = LinearAttention(channels_sa, heads=8)

        self.fp_stages = build_fp_stages(fp_blocks, vres_mult=vres_mult)
        for fp_idx, stage in enumerate(self.fp_stages):
            fp = PointNetFPModule(c + embed_dim + skip_channels[-1 - fp_idx],
                                  stage.fp_out, **kw)
            self.add_module(f"fp{fp_idx}_fp", fp)
            c = fp.out_channels
            for j, spec in enumerate(stage.convs):
                self.add_module(f"fp{fp_idx}_conv{j}",
                                self._conv(c, spec, kw))
                c = spec.out_channels

        # classifier head: SharedMLP(128) -> (dropout) -> Dense(num_classes)
        self.cls_mlp = SharedMLP(c, (128,), **kw)
        self.cls_out = TDense(num_classes, 128)

    @staticmethod
    def _conv(cin, spec, kw):
        if spec.resolution is None:
            return SharedMLP(cin, (spec.out_channels,), **kw)
        return PVConv(cin, spec.out_channels, spec.resolution,
                      attention=spec.attention, **kw)

    def _run_conv(self, name, features, coords, style):
        mod = getattr(self, name)
        if isinstance(mod, PVConv):
            return mod(features, coords, style)
        return mod(features, style)

    def forward(self, inputs, t=None, style=None):
        """inputs (B, N, input_dim + extra) -> (B, N, num_classes)."""
        b = inputs.shape[0]
        coords = inputs[..., :self.input_dim]
        features = inputs

        temb = None
        if t is not None and self.embed_dim > 0:
            t = torch.as_tensor(t, dtype=torch.float32,
                                device=inputs.device).reshape(-1).expand(b)
            emb = timestep_embedding(t, self.embed_dim, self.time_emb_scales)
            emb = nn.functional.leaky_relu(self.embedf0(emb), 0.1)
            temb = self.embedf1(emb)                           # (B, D)

        def with_temb(feat):
            if temb is None:
                return feat
            tt = temb[:, None, :].expand(-1, feat.shape[1], -1)
            return torch.cat([feat, tt], dim=-1)

        coords_list, in_features_list = [], []
        for i, stage in enumerate(self.sa_stages):
            in_features_list.append(features)
            coords_list.append(coords)
            if i > 0:
                features = with_temb(features)
            for j in range(len(stage.convs)):
                features = self._run_conv(f"sa{i}_conv{j}", features, coords,
                                          style)
            if stage.sa is not None:
                features, coords = getattr(self, f"sa{i}_sa")(
                    features, coords, style)

        extra_feats = inputs[..., 3:]
        in_features_list[0] = extra_feats if extra_feats.shape[-1] > 0 \
            else None

        features = self.global_att(features)

        for fp_idx, stage in enumerate(self.fp_stages):
            target_coords = coords_list[-1 - fp_idx]
            features = getattr(self, f"fp{fp_idx}_fp")(
                target_coords, coords, with_temb(features),
                in_features_list[-1 - fp_idx], style)
            coords = target_coords
            for j in range(len(stage.convs)):
                features = self._run_conv(f"fp{fp_idx}_conv{j}", features,
                                          coords, style)

        return self.cls_out(self.cls_mlp(features, style))
