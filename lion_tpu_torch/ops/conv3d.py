"""Fused eval-path 3x3x3 convolution (port of conv3d_3x3_fused,
lion_tpu/ops/pallas/conv3d.py:441-474).

Kernel here:
  K4 `conv3d_3x3_fused` (csrc/conv3d.cu).

y = conv3d_SAME(swish?(x * in_scale + in_bias), w), bias-free, plus the
per-channel statistics stats[b] = (sum of y, sum of y^2) over the grid, which
the caller folds with the conv bias into the next GroupNorm. The prologue
applies to in-grid inputs only: the zero halo is added after it.
Inference only: no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._cuda import check_cuda, kernel, launch, ptr, stream_of


def _conv3d_3x3_fused_plain(x: torch.Tensor, w: torch.Tensor,
                            in_scale: Optional[torch.Tensor] = None,
                            in_bias: Optional[torch.Tensor] = None,
                            pre_swish: bool = False):
    xx = x.float()
    if in_scale is not None:
        xx = xx * in_scale[:, None, None, None, :] \
            + in_bias[:, None, None, None, :]
    if pre_swish:
        xx = xx * torch.sigmoid(xx)
    y = F.conv3d(xx.permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 padding=1)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return y, stats


@kernel("conv3d_3x3_fused", _conv3d_3x3_fused_plain,
        "lion_tpu_torch/csrc/conv3d.cu",
        "lion_tpu/ops/pallas/conv3d.py:441")
def conv3d_3x3_fused(x: torch.Tensor, w: torch.Tensor,
                     in_scale: Optional[torch.Tensor] = None,
                     in_bias: Optional[torch.Tensor] = None,
                     pre_swish: bool = False):
    """x (B, R, R, R, Ci), w (3, 3, 3, Ci, Co), in_scale/in_bias (B, Ci) or
    None -> (y (B, R, R, R, Co), stats (B, 2, Co) f32)."""
    if (in_scale is None) != (in_bias is None):
        raise ValueError("in_scale and in_bias go together")
    check_cuda(x, w, in_scale, in_bias)
    b, r = x.shape[0], x.shape[1]
    ci, co = w.shape[3], w.shape[4]
    if x.shape[1:] != (r, r, r, ci) or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"conv3d_3x3_fused: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    y = torch.empty((b, r, r, r, co), device=x.device)
    stats = torch.zeros((b, 2, co), device=x.device)
    launch("lion_conv3d_3x3_fused", ptr(x), ptr(w), ptr(in_scale),
           ptr(in_bias), ptr(y), ptr(stats), b, r, ci, co, int(pre_swish),
           stream_of(x))
    return y, stats
