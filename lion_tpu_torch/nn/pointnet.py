"""PointNet++ set-abstraction / feature-propagation modules (port of
lion_tpu/nn/pointnet.py, the fp32 path: the SA block runs FPS, the fused
ball-query+group kernel and a SharedMLP, then a max over the neighbours)."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.interpolate import nearest_neighbor_interpolate
from ..ops.points import ball_query_group, furthest_point_sample
from .common import SharedMLP


def _as_branches(out_channels) -> Tuple[Tuple[int, ...], ...]:
    if not isinstance(out_channels, (list, tuple)):
        return ((int(out_channels),),)
    if not isinstance(out_channels[0], (list, tuple)):
        return (tuple(int(c) for c in out_channels),)
    return tuple(tuple(int(c) for c in br) for br in out_channels)


class PointNetAModule(nn.Module):
    """Aggregate-all module: [features ++ xyz] -> MLP -> global max."""

    def __init__(self, in_channels: int, out_channels, ada: bool = False,
                 style_dim: int = 128, init_scale: float = 1.0):
        super().__init__()
        self.branches = _as_branches(out_channels)
        for i, br in enumerate(self.branches):
            self.add_module(f"mlp{i}", SharedMLP(in_channels + 3, br, ada,
                                                 style_dim, init_scale))
        self.out_channels = sum(br[-1] for br in self.branches)

    def forward(self, features, coords, style=None):
        x = torch.cat([features, coords[..., :3]], dim=-1)
        outs = [getattr(self, f"mlp{i}")(x, style).amax(dim=1, keepdim=True)
                for i in range(len(self.branches))]
        new_coords = coords.new_zeros((coords.shape[0], 1, 3))
        return torch.cat(outs, dim=-1), new_coords


class PointNetSAModule(nn.Module):
    """FPS + ball-query grouping + SharedMLP + max over neighbours."""

    def __init__(self, num_centers: int, radius: Union[float, Sequence[float]],
                 num_neighbors: Union[int, Sequence[int]], in_channels: int,
                 out_channels, ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0):
        super().__init__()
        self.num_centers = num_centers
        self.radius = list(radius) if isinstance(radius, (list, tuple)) \
            else [radius]
        self.num_neighbors = list(num_neighbors) \
            if isinstance(num_neighbors, (list, tuple)) \
            else [num_neighbors] * len(self.radius)
        branches = _as_branches(out_channels)
        if len(branches) == 1 and len(self.radius) > 1:
            branches = branches * len(self.radius)
        self.branches = branches
        for i, br in enumerate(branches):
            self.add_module(f"mlp{i}", SharedMLP(in_channels + 3, br, ada,
                                                 style_dim, init_scale))
        self.out_channels = sum(br[-1] for br in branches)

    def forward(self, features, coords, style=None):
        """features (B, N, C), coords (B, N, >=3) ->
        (new_features (B, M, C'), centers (B, M, 3))."""
        xyz = coords[..., :3].contiguous()
        centers = furthest_point_sample(xyz, self.num_centers)
        feats = features.contiguous()
        outs = []
        for i, (r, k) in enumerate(zip(self.radius, self.num_neighbors)):
            grouped = ball_query_group(xyz, centers, feats, r, k)
            h = getattr(self, f"mlp{i}")(grouped, style)   # (B, M, K, C)
            outs.append(h.amax(dim=2))
        return torch.cat(outs, dim=-1), centers


class PointNetFPModule(nn.Module):
    """3-NN inverse-distance interpolation + SharedMLP."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0):
        super().__init__()
        self.mlp = SharedMLP(in_channels, tuple(out_channels), ada, style_dim,
                             init_scale)
        self.out_channels = self.mlp.out_channels

    def forward(self, points_coords, centers_coords, centers_features,
                points_features=None, style=None):
        """points_coords (B, N, >=3), centers_coords (B, M, >=3),
        centers_features (B, M, C) -> (B, N, C')."""
        interp = nearest_neighbor_interpolate(
            points_coords[..., :3].contiguous(),
            centers_coords[..., :3].contiguous(),
            centers_features.contiguous())
        if points_features is not None:
            interp = torch.cat([interp, points_features], dim=-1)
        return self.mlp(interp, style)
