"""PointNet++ set-abstraction / feature-propagation modules (port of
lion_tpu/nn/pointnet.py).

The SA block runs FPS, then either the fused bf16 kernel (K7, where
`_fused_ok` holds: eval mode, lion_tpu/nn/pointnet.py:103-150) or the fused
ball-query+group kernel and a SharedMLP, then a max over the neighbours.
In train mode the second branch runs, with gradients through
`ball_query_group` (K2 in the features' dtype, fp32 or bf16); the FP and A
modules get theirs through `nearest_neighbor_interpolate` and plain
PyTorch.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.interpolate import nearest_neighbor_interpolate
from ..ops.points import ball_query_group, furthest_point_sample
from ..ops.sa_fused import sa_fused, supports_sa_fused
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
                 style_dim: int = 128, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.branches = _as_branches(out_channels)
        for i, br in enumerate(self.branches):
            self.add_module(f"mlp{i}", SharedMLP(in_channels + 3, br, ada,
                                                 style_dim, init_scale,
                                                 dtype=dtype))
        self.out_channels = sum(br[-1] for br in self.branches)

    def forward(self, features, coords, style=None):
        xyz = coords[..., :3]
        x = torch.cat([features.to(xyz.dtype), xyz], dim=-1)
        outs = [getattr(self, f"mlp{i}")(x, style).amax(dim=1, keepdim=True)
                for i in range(len(self.branches))]
        new_coords = coords.new_zeros((coords.shape[0], 1, 3))
        return torch.cat(outs, dim=-1), new_coords


class PointNetSAModule(nn.Module):
    """FPS + ball-query grouping + SharedMLP + max over neighbours."""

    def __init__(self, num_centers: int, radius: Union[float, Sequence[float]],
                 num_neighbors: Union[int, Sequence[int]], in_channels: int,
                 out_channels, ada: bool = False, style_dim: int = 128,
                 init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_centers = num_centers
        self.dtype = dtype
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
                                                 style_dim, init_scale,
                                                 dtype=dtype))
        self.out_channels = sum(br[-1] for br in branches)

    def _fused_ok(self) -> bool:
        """Single-branch bf16 eval with shapes the fused SA kernel takes
        (lion_tpu/nn/pointnet.py:103-119 without its backend test; the
        kernel also bounds K to 128 and the widths to 256)."""
        return (not self.training and self.dtype == torch.bfloat16
                and len(self.branches) == 1
                and len(self.radius) == 1
                and supports_sa_fused(self.num_centers, self.num_neighbors[0],
                                      self.branches[0]))

    def _fused_branch(self, xyz, centers, features, style):
        """The whole SA block in K7: the first dense layer commutes with the
        gather, so A = [xyz ++ feats] @ W1 + b1 per point and the center
        term -(centers @ W1[:3]) are computed here (lion_tpu/nn/pointnet.py:
        121-150), the rest in the kernel."""
        dt = self.dtype
        layers = self.mlp0.fold(style, xyz.shape[0])
        w1, b1 = layers[0][0], layers[0][1]
        x = torch.cat([xyz, features.to(xyz.dtype)], dim=-1).to(dt)
        a = torch.matmul(x, w1.to(dt)).float() + b1
        bc = -torch.matmul(centers.to(dt), w1[:3].to(dt)).float()
        return sa_fused(
            xyz, centers, a.contiguous(), bc.contiguous(),
            [kern.detach().to(dt) for kern, _, _, _ in layers[1:]],
            [bias.detach() for _, bias, _, _ in layers[1:]],
            [ca.contiguous() for _, _, ca, _ in layers],
            [cb.contiguous() for _, _, _, cb in layers],
            self.radius[0], self.num_neighbors[0])

    def forward(self, features, coords, style=None):
        """features (B, N, C), coords (B, N, >=3) ->
        (new_features (B, M, C'), centers (B, M, 3))."""
        xyz = coords[..., :3].contiguous()
        centers = furthest_point_sample(xyz, self.num_centers)
        if self._fused_ok():
            return self._fused_branch(xyz, centers, features, style), centers
        # K2 emits the features' dtype, as the JAX form concatenates the
        # rows (lion_tpu/ops/points.py:183-190)
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
                 init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, tuple(out_channels), ada, style_dim,
                             init_scale, dtype=dtype)
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
            dt = torch.promote_types(interp.dtype, points_features.dtype)
            interp = torch.cat([interp.to(dt), points_features.to(dt)],
                               dim=-1)
        return self.mlp(interp, style)
