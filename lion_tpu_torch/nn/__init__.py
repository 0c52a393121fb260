from .common import (AdaGN, Conv3dSame, GNAffine, LinearAttention, Normalizer,
                     SE, SharedMLP, TDense, gn_affine_from_stats, group_norm,
                     init_weights, swish, timestep_embedding)
from .pointnet import PointNetAModule, PointNetFPModule, PointNetSAModule
from .pvconv import PVConv
from .unet import PVCNN2Unet, build_fp_stages, build_sa_stages

__all__ = [
    "AdaGN", "Conv3dSame", "GNAffine", "LinearAttention", "Normalizer", "SE",
    "SharedMLP", "TDense", "gn_affine_from_stats", "group_norm",
    "init_weights", "swish", "timestep_embedding", "PointNetAModule",
    "PointNetFPModule", "PointNetSAModule", "PVConv", "PVCNN2Unet",
    "build_fp_stages", "build_sa_stages",
]
