"""Point-cloud ops of the port, each beside its plain PyTorch version.

`KERNELS` maps each kernel's name to its wrapper (see `_cuda.kernel`);
`reset_counts()` zeroes their launch and plain-call counters.
"""
from ._cuda import KERNELS, reset_counts
from .conv3d import conv3d_3x3_fused
from .interpolate import nearest_neighbor_interpolate
from .points import (ball_query, ball_query_group, fps,
                     furthest_point_sample, furthest_point_sample_idx,
                     gather, grouping)
from .voxel import (avg_voxelize, normalize_coords, trilinear_devoxelize,
                    voxelize)

__all__ = [
    "KERNELS", "reset_counts", "conv3d_3x3_fused",
    "nearest_neighbor_interpolate", "ball_query", "ball_query_group", "fps",
    "furthest_point_sample", "furthest_point_sample_idx", "gather",
    "grouping", "avg_voxelize", "normalize_coords", "trilinear_devoxelize",
    "voxelize",
]
