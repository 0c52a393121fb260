"""Fused PointNet++ set abstraction in bf16 (port of
pointnet_sa_fused_pallas, lion_tpu/ops/pallas/sa_fused.py:249).

Kernel here:
  K7 `sa_fused` (csrc/sa_fused.cu).

One SA block of the sampling path, with its grouped (B, M, K, C) tensors
kept in the kernel's scratch:

    ball query -> gather of the first dense layer's rows -> [GroupNorm(8)
    -> channel affine -> swish -> next dense] per layer -> max over K

  * Ball query: the first K points with d2 < r^2 in index order; slots past
    the hit count copy slot 0; an empty ball takes point 0. Hits are counted
    in integers.
  * Layer 1 commutes with the gather: z1[m, j] = A[p(m, j)] + bc[m] with
    A = [xyz ++ feats] @ W1 + b1 per point and bc = -(centers @ W1[:3]),
    both computed by the caller (torch.matmul, as the JAX package leaves
    them to XLA). z is stored as bf16.
  * Miss slots are copies of slot 0 and take part in the statistics.
  * GroupNorm statistics are global per (item, group): over all M*K slots
    and the group's channels, of the rounded z, with the centered variance
    E[(z - mu)^2] and eps 1e-5. h = swish(GN0(z) * ca + cb), rounded to
    bf16; the next layer's z = bf16(h @ W + b) with float32 sums.
  * The output is the max of the last h over the K slots, (B, M, C_L) bf16
    (the TPU kernel's channel-first output is a layout, not semantics).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of
from .conv3d import GN_EPS, GN_GROUPS
from .points import _ball_query_plain, _r2

ROWS = 128        # slot rows (centers x K) per block of the kernel
MAX_WIDTH = 256


def sa_tile(m: int, k: int) -> int:
    """Centers per block: ROWS // k, halved until it divides M."""
    tm = max(1, ROWS // k)
    while m % tm:
        tm //= 2
    return tm


def supports_sa_fused(m: int, k: int, widths: Sequence[int]) -> bool:
    """Shapes the kernel takes: K a power of two in [8, 128], M a multiple
    of 8, every width a multiple of 8 and at most 256."""
    return (k & (k - 1) == 0 and 8 <= k <= ROWS and m % 8 == 0
            and all(c % 8 == 0 and 0 < c <= MAX_WIDTH for c in widths))


def _group_stats(z: torch.Tensor):
    """Per-channel (mean, rsqrt(var + eps)) (B, C) of GroupNorm(8) over all
    slots of each item, with the centered variance."""
    b, c = z.shape[0], z.shape[-1]
    zg = z.reshape(b, -1, GN_GROUPS, c // GN_GROUPS)
    mu = zg.mean(dim=(1, 3), keepdim=True)
    var = ((zg - mu) * (zg - mu)).mean(dim=(1, 3))
    rs = torch.rsqrt(var + GN_EPS)                          # (B, G)
    per = c // GN_GROUPS
    return (mu.reshape(b, GN_GROUPS).repeat_interleave(per, dim=1),
            rs.repeat_interleave(per, dim=1))


def _sa_fused_plain(points, centers, a, bc, ws, bs, cas, cbs, radius, k):
    b, m = centers.shape[:2]
    c1 = a.shape[-1]
    idx = _ball_query_plain(centers, points, radius, k).reshape(
        b, m * k).long()
    z = torch.gather(a, 1, idx[:, :, None].expand(-1, -1, c1))
    z = (z.reshape(b, m, k, c1) + bc[:, :, None, :]).to(torch.bfloat16)
    for layer, (ca, cb) in enumerate(zip(cas, cbs)):
        zf = z.float()
        mu, rs = _group_stats(zf)
        sc = rs * ca
        sh = cb - mu * sc
        hf = zf * sc[:, None, None, :] + sh[:, None, None, :]
        h = (hf * torch.sigmoid(hf)).to(torch.bfloat16)
        if layer + 1 < len(cas):
            z = (torch.matmul(h.float(), ws[layer].float())
                 + bs[layer]).to(torch.bfloat16)
    return h.amax(dim=2)


@kernel("sa_fused", _sa_fused_plain, "lion_tpu_torch/csrc/sa_fused.cu",
        "lion_tpu/ops/pallas/sa_fused.py:249")
def sa_fused(points: torch.Tensor, centers: torch.Tensor, a: torch.Tensor,
             bc: torch.Tensor, ws: Sequence[torch.Tensor],
             bs: Sequence[torch.Tensor], cas: Sequence[torch.Tensor],
             cbs: Sequence[torch.Tensor], radius: float, k: int):
    """points (B, N, 3), centers (B, M, 3), a (B, N, C1), bc (B, M, C1), all
    f32; ws: the (C_{l-1}, C_l) bf16 kernels of layers 2..L; bs: their
    (C_l,) f32 biases; cas, cbs: the (B, C_l) f32 post-norm channel affines
    of layers 1..L -> (B, M, C_L) bf16. Several launches, no PyTorch op
    between them: ball query + layer 1, then per layer the statistics and
    the next dense layer (or the max over K after the last)."""
    check_cuda(points, centers, a, bc)
    b, n, _ = points.shape
    m = centers.shape[1]
    widths = [ca.shape[-1] for ca in cas]
    if (len(ws) != len(widths) - 1 or len(bs) != len(ws)
            or a.shape != (b, n, widths[0]) or bc.shape != (b, m, widths[0])
            or not supports_sa_fused(m, k, widths)):
        raise ValueError(f"sa_fused: M={m}, K={k}, widths {widths}")
    dev = points.device
    for i, wt in enumerate(ws):
        check_cuda(wt, dtype=torch.bfloat16, device=dev)
        if wt.shape != (widths[i], widths[i + 1]):
            raise ValueError(f"sa_fused: layer {i + 2} kernel {wt.shape}")
    w = torch.cat([wt.reshape(-1) for wt in ws]) if ws else None
    bias = torch.cat(list(bs)) if bs else None
    ca = torch.cat(list(cas), dim=1).contiguous()
    cb = torch.cat(list(cbs), dim=1).contiguous()
    check_cuda(bias, ca, cb, device=dev)
    if ca.shape != (b, sum(widths)) or cb.shape != ca.shape:
        raise ValueError(f"sa_fused: affines {ca.shape}, {cb.shape}")
    tm = sa_tile(m, k)
    cmax = max(widths)
    zs = torch.empty((2, b * m * k * cmax), dtype=torch.bfloat16, device=dev)
    part = torch.empty((b * (m // tm) * 2 * cmax,), device=dev)
    scsh = torch.empty((2 * b * cmax,), device=dev)
    out = torch.empty((b, m, widths[-1]), dtype=torch.bfloat16, device=dev)
    host_widths = (ctypes.c_int * len(widths))(*widths)
    launch("lion_sa_fused", ptr(points), ptr(centers), ptr(a), ptr(bc),
           ptr(w), ptr(bias), ptr(ca), ptr(cb),
           ctypes.addressof(host_widths), len(widths), ptr(zs[0]),
           ptr(zs[1]), ptr(part), ptr(scsh), ptr(out), b, n, m, k, tm,
           _r2(radius), stream_of(points))
    return out
