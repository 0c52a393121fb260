"""Point-cloud ops of the port, each beside its plain PyTorch version.

`KERNELS` maps each kernel's name to its wrapper (see `_cuda.kernel`);
`reset_counts()` zeroes their launch and plain-call counters. The ops
exported here that the training path differentiates (`conv3d_3x3_same`,
`ball_query_group`, `avg_voxelize`, `trilinear_devoxelize`,
`nearest_neighbor_interpolate`, and `ball_query_group_cf`) are
`torch.autograd.Function`s around their kernels, whose backwards sum rows
in a fixed order (`scatter_rows`, the row-sum kernel); `emd_cost` has no
gradient (`emd_approx` is the differentiable form). DiT-3D's softmax
`attention` is one too, its backward a fused kernel of its own.
"""
from ._cuda import KERNELS, reset_counts
from .attention import attention
from .chamfer import chamfer, chamfer_dist, chamfer_l1
from .conv3d import (conv3d_3x3_fused, conv3d_3x3_same, conv3d_pair,
                     conv3d_weight_grad)
from .emd import approx_match, emd_approx, emd_cost
from .interpolate import nearest_neighbor_interpolate
from .points import (ball_query, ball_query_group, ball_query_group_cf, fps,
                     furthest_point_sample, furthest_point_sample_idx,
                     gather, grouping)
from .pvblock import pvconv_block_pair
from .rows import gather_rows, row_sum, scatter_rows
from .sa_fused import sa_fused
from .voxel import (avg_voxelize, normalize_coords, trilinear_devoxelize,
                    voxelize)

__all__ = [
    "KERNELS", "reset_counts", "attention", "chamfer", "chamfer_dist",
    "chamfer_l1",
    "conv3d_3x3_fused", "conv3d_3x3_same", "conv3d_pair",
    "conv3d_weight_grad", "approx_match",
    "emd_approx", "emd_cost", "nearest_neighbor_interpolate", "ball_query",
    "ball_query_group", "ball_query_group_cf", "fps",
    "furthest_point_sample", "furthest_point_sample_idx", "gather",
    "grouping", "pvconv_block_pair", "gather_rows", "row_sum",
    "scatter_rows", "sa_fused", "avg_voxelize",
    "normalize_coords", "trilinear_devoxelize", "voxelize",
]
