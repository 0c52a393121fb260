"""Point sampling and grouping ops (port of lion_tpu/ops/points.py).

Channels-last like the JAX package: coords (B, N, 3), features (B, N, C).

Kernels here:
  K1 `fps` (csrc/fps.cu): furthest point sampling, indices and the picked
     coords in one launch.
  K2 `ball_query_group` (csrc/ball_query_group.cu): ball query fused with
     the grouping gather, fp32 or bf16 features; `bqg_plan` sizes its
     blocks.
  K11 `ball_query` (csrc/ball_query.cu): the index-only ball query;
     `bq_plan` sizes its blocks.
  K13 `ball_query_group_cf` (csrc/ball_query_group_cf.cu): K2 with the
     channel-first (B, K, 3 + C, M) output, fp32 or bf16 features;
     `bqg_cf_plan` sizes its blocks.
The three find their balls by one scan (csrc/ball_scan.cuh), each with
its own epilogue.

`ball_query_group` has a gradient: its backward recomputes the indices
with K11, as the JAX VJP replays `ball_query` (lion_tpu/ops/points.py:
241-254), and sums the output gradient's rows into the point coordinates
and the features in a fixed order (`rows.scatter_rows`, one row sum for
both) and, negated and summed over K, into the centers; each gradient in
its input's dtype.
`ball_query_group_cf` permutes its gradient to the row layout and runs the
same backward.

Each plain version computes squared distances op by op as
((dx*dx + dy*dy) + dz*dz), the order the kernels use with unfused
arithmetic, so kernel and plain version pick the same indices bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ._cuda import check_cuda, check_float, kernel, launch, ptr, stream_of
from .rows import scatter_rows


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, 3), (..., N, 3) -> (..., M, N) exact subtract-square form."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# --------------------------------------------------------------------------
# K1: furthest point sampling
# --------------------------------------------------------------------------
# K1's plan (csrc/fps.cu: fps_plan, whose constants these equal): one warp
# up to FPS_WARP_MAX_N points, else a block of several warps with at least
# FPS_BLOCK_P points a thread, at most FPS_MAX_THREADS threads and FPS_MAX_P
# points a thread; 12 bytes of shared memory a point, beside 512 static.
FPS_MAX_THREADS, FPS_WARP_MAX_N, FPS_BLOCK_P, FPS_MAX_P = 1024, 256, 2, 16
FPS_MAX_N = FPS_MAX_THREADS * FPS_MAX_P


def fps_plan(n: int):
    """(threads, points per thread P, dynamic shared bytes) of K1 for a
    cloud of n points: thread t owns points t, t + threads, ... (P of them,
    in registers); P is a power of two."""
    if not 1 <= n <= FPS_MAX_N:
        raise ValueError(f"fps: N={n} outside [1, {FPS_MAX_N}]")
    p = 1
    if n <= FPS_WARP_MAX_N:
        while 32 * p < n:
            p *= 2
        return 32, p, 12 * n
    p = FPS_BLOCK_P
    while FPS_MAX_THREADS * p < n:
        p *= 2
    return 32 * -(-n // (32 * p)), p, 12 * n


def _fps_plain(coords: torch.Tensor, num_samples: int):
    """coords (B, N, 3) -> (idx (B, M) int32, centers (B, M, 3)).

    Index 0 seeds the chain; each next pick is the argmax of the running
    min squared distance (torch.argmax returns the first maximum, so ties
    go to the lowest index)."""
    b, n, _ = coords.shape
    xyz = coords.float()
    rows = torch.arange(b, device=xyz.device)
    min_d2 = torch.full((b, n), float("inf"), device=xyz.device)
    idx = torch.zeros((b, num_samples), dtype=torch.long, device=xyz.device)
    last = idx[:, 0]
    for i in range(1, num_samples):
        d = xyz - xyz[rows, last][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=1)
        idx[:, i] = last
    centers = torch.gather(xyz, 1, idx[:, :, None].expand(-1, -1, 3))
    return idx.to(torch.int32), centers


@kernel("fps", _fps_plain, "lion_tpu_torch/csrc/fps.cu",
        "lion_tpu/ops/pallas/fps.py:112")
def fps(coords: torch.Tensor, num_samples: int):
    """coords (B, N, 3) -> (idx (B, M) int32, centers (B, M, 3) f32)."""
    check_cuda(coords)
    b, n, _ = coords.shape
    if not 1 <= num_samples <= n or n > FPS_MAX_N:
        raise ValueError(f"fps: unsupported N={n}, M={num_samples}")
    idx = torch.empty((b, num_samples), dtype=torch.int32, device=coords.device)
    centers = torch.empty((b, num_samples, 3), device=coords.device)
    launch("lion_fps", ptr(coords), ptr(idx), ptr(centers), b, n,
           num_samples, stream_of(coords))
    return idx, centers


def furthest_point_sample_idx(coords: torch.Tensor,
                              num_samples: int) -> torch.Tensor:
    """coords (B, N, 3) -> (B, num_samples) int32 indices."""
    return fps(coords.detach().contiguous(), num_samples)[0]


def furthest_point_sample(coords: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """coords (B, N, 3) -> sampled centers (B, num_samples, 3)."""
    return fps(coords.detach().contiguous(), num_samples)[1]


# --------------------------------------------------------------------------
# grouping / gather
# --------------------------------------------------------------------------
def grouping(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), indices (B, M, K) -> (B, M, K, C)."""
    b, _, c = features.shape
    _, m, k = indices.shape
    flat = indices.reshape(b, m * k).long()
    out = torch.gather(features, 1, flat[:, :, None].expand(-1, -1, c))
    return out.reshape(b, m, k, c)


def gather(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (B, N, C), indices (B, M) -> (B, M, C)."""
    idx = indices.long()[:, :, None].expand(-1, -1, features.shape[-1])
    return torch.gather(features, 1, idx)


# --------------------------------------------------------------------------
# The ball queries' plans: K2, K11, K13
# --------------------------------------------------------------------------
# The shared scan's constants (csrc/ball_scan.cuh, whose constants these
# equal): cloud points a shared-memory tile, 32-point chunks a warp tests a
# round. The three kernels' limits (csrc/ball_query_group.cu, ball_query.cu
# and ball_query_group_cf.cu, whose constants these equal): threads a
# block, centers a block, a block's shared memory. The plans' target: two
# waves of blocks on the H100's 132 SMs.
BQG_TILE, BQG_CHUNKS = 2048, 4
BQG_MAX_THREADS, BQG_MAX_CENTERS = 256, 32
BQG_SMEM_MAX, BQG_MIN_BLOCKS = 232448, 264


def _centers_a_block(b: int, m: int, fits, floor: int = 1,
                     min_blocks: int = BQG_MIN_BLOCKS) -> int:
    """The most centers a block, a power of two up to BQG_MAX_CENTERS and
    below 2 M, whose blocks still number `min_blocks` and fit the shared
    memory (`fits(cpb)`); never below `floor` but to fit."""
    cpb = BQG_MAX_CENTERS
    while cpb > 1 and (not fits(cpb) or cpb > floor and (
            cpb >= 2 * m or -(-m // cpb) * b < min_blocks)):
        cpb //= 2
    return cpb


def _checked(name: str, smem: int, k: int) -> int:
    if smem > BQG_SMEM_MAX:
        raise ValueError(f"{name}: K={k} beyond shared memory")
    return smem


def bqg_smem(cpb: int, k: int, tile: int, threads: int) -> int:
    """K2's dynamic shared bytes: the cloud tile (padded by a round of
    32 BQG_CHUNKS points) and each warp's 2 K rows as float4, the cpb K
    slots' indices and the cpb hit counts as int32."""
    return 16 * (tile + 32 * BQG_CHUNKS) + 16 * (threads // 32) * 2 * k \
        + 4 * cpb * k + 4 * cpb


def bqg_plan(b: int, n: int, m: int, c: int, k: int):
    """(centers a block, threads, cloud tile, shared bytes) of K2: the most
    centers a block (`_centers_a_block`); a warp for each pair of them, up
    to BQG_MAX_THREADS threads, which a block of one pair (cpb <= 2) takes
    all to write it."""
    if n < 1 or k < 1:
        raise ValueError(f"ball_query_group: unsupported N={n}, K={k}")
    tile = min(n, BQG_TILE)

    def threads(cpb):
        return BQG_MAX_THREADS if cpb <= 2 else min(BQG_MAX_THREADS,
                                                    32 * -(-cpb // 2))
    cpb = _centers_a_block(b, m, lambda cpb: bqg_smem(
        cpb, k, tile, threads(cpb)) <= BQG_SMEM_MAX)
    smem = _checked("ball_query_group",
                    bqg_smem(cpb, k, tile, threads(cpb)), k)
    return cpb, threads(cpb), tile, smem


def bq_smem(cpb: int, k: int, tile: int) -> int:
    """K11's dynamic shared bytes: the padded cloud tile as float4, the
    cpb K slots' indices and the cpb hit counts as int32."""
    return 16 * (tile + 32 * BQG_CHUNKS) + 4 * cpb * k + 4 * cpb


def bq_plan(b: int, n: int, m: int, k: int):
    """(centers a block, threads, cloud tile, shared bytes) of K11: the
    most centers a block (`_centers_a_block`) and BQG_MAX_THREADS threads,
    which stage the cloud (a warp scans a pair of centers; the warps
    without one only stage: at the small levels that is most of the
    work)."""
    if n < 1 or k < 1:
        raise ValueError(f"ball_query: unsupported N={n}, K={k}")
    tile = min(n, BQG_TILE)
    cpb = _centers_a_block(b, m, lambda cpb: bq_smem(cpb, k, tile)
                           <= BQG_SMEM_MAX)
    smem = _checked("ball_query", bq_smem(cpb, k, tile), k)
    return cpb, BQG_MAX_THREADS, tile, smem


CF_ROWS = 32         # K13's feature rows a warp stages at once
# K13's plan: at least this many centers a block where M allows (row
# segments of 64 bytes fp32, 32 bf16), and this many blocks, the slots
# split in groups to reach them (measured at the SA levels, B16)
CF_MIN_CENTERS, CF_MIN_BLOCKS = 16, 256


def bqg_cf_smem(cpb: int, k: int, tile: int, threads: int, size: int) -> int:
    """K13's dynamic shared bytes for features of `size` bytes: the padded
    cloud tile as float4, or in its place after the scan each warp's
    transpose buffer (CF_ROWS rows of cpb + 1 values), whichever is
    larger (to 16 bytes), then the cpb K slots' indices, the cpb hit counts
    and the cpb K filled slots as int32."""
    bufs = threads // 32 * CF_ROWS * (cpb + 1) * size
    area = max(16 * (tile + 32 * BQG_CHUNKS), -(-bufs // 16) * 16)
    return area + 8 * cpb * k + 4 * cpb


def bqg_cf_plan(b: int, n: int, m: int, c: int, k: int, size: int):
    """(centers a block, slot groups, threads, cloud tile, shared bytes) of
    K13 for features of `size` bytes: the most centers a block
    (`_centers_a_block` for CF_MIN_BLOCKS, not below CF_MIN_CENTERS); then
    the fewest slot groups, of ceil(K / 2^i) slots each, whose blocks
    number CF_MIN_BLOCKS (each group's block scans its centers again);
    BQG_MAX_THREADS threads."""
    if n < 1 or k < 1 or c < 0:
        raise ValueError(f"ball_query_group_cf: unsupported N={n}, K={k}")
    tile, threads = min(n, BQG_TILE), BQG_MAX_THREADS
    cpb = _centers_a_block(b, m, lambda cpb: bqg_cf_smem(
        cpb, k, tile, threads, size) <= BQG_SMEM_MAX,
        floor=CF_MIN_CENTERS, min_blocks=CF_MIN_BLOCKS)
    smem = _checked("ball_query_group_cf",
                    bqg_cf_smem(cpb, k, tile, threads, size), k)
    groups = 1
    while 2 * groups <= k and -(-m // cpb) * b * groups < CF_MIN_BLOCKS:
        groups *= 2
    ks = -(-k // groups)                   # slots a group; none is empty
    return cpb, -(-k // ks), threads, tile, smem


# --------------------------------------------------------------------------
# K11: ball query
# --------------------------------------------------------------------------
def _r2(radius: float) -> float:
    """The squared radius as the JAX forms compute it: float32(r) ** 2."""
    return float(np.float32(radius) * np.float32(radius))


def _ball_query_plain(centers: torch.Tensor, points: torch.Tensor,
                      radius: float, num_neighbors: int) -> torch.Tensor:
    """The top-k form: the first K keys, a point's key being its index if
    it lies in the ball and N + its index if not (K > N pads with misses)."""
    n = points.shape[1]
    d2 = _sq_dist(centers.float(), points.float())           # (B, M, N)
    mask = d2 < _r2(radius)
    iota = torch.arange(n, device=points.device).expand_as(d2)
    key = torch.where(mask, iota, iota + n)
    kth = torch.topk(key, min(num_neighbors, n), dim=-1, largest=False,
                     sorted=True).values
    kth = torch.nn.functional.pad(kth, (0, num_neighbors - kth.shape[-1]),
                                  value=n)
    valid = kth < n
    idx = torch.where(valid, kth, torch.zeros_like(kth))
    return torch.where(valid, idx, idx[..., :1].expand_as(idx)).to(
        torch.int32)


@kernel("ball_query", _ball_query_plain, "lion_tpu_torch/csrc/ball_query.cu",
        "lion_tpu/ops/pallas/ball_query.py:56")
def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               num_neighbors: int) -> torch.Tensor:
    """centers (B, M, 3), points (B, N, 3) f32 -> (B, M, K) int32 indices.

    The first K points with d2 < r^2 in index order; partial rows repeat
    the first hit, empty rows are all 0 (ball_query.py:83-87)."""
    check_cuda(centers, points)
    b, m, _ = centers.shape
    n = points.shape[1]
    cpb, threads, tile, _ = bq_plan(b, n, m, num_neighbors)
    out = torch.empty((b, m, num_neighbors), dtype=torch.int32,
                      device=centers.device)
    launch("lion_ball_query", ptr(centers), ptr(points), ptr(out), b, n, m,
           num_neighbors, _r2(radius), cpb, threads, tile, stream_of(centers))
    return out


# --------------------------------------------------------------------------
# K2: ball query + grouping
# --------------------------------------------------------------------------
def _ball_query_group_plain(points_coords, centers_coords, points_features,
                            radius: float, num_neighbors: int):
    """The rows in the features' dtype: point - center in fp32 rounded
    once, the features gathered exactly."""
    idx = _ball_query_plain(centers_coords, points_coords, radius,
                            num_neighbors)
    rel = grouping(points_coords.float(), idx) - centers_coords[:, :, None, :]
    feats = grouping(points_features, idx)
    return torch.cat([rel.to(feats.dtype), feats], dim=-1)


@kernel("ball_query_group", _ball_query_group_plain,
        "lion_tpu_torch/csrc/ball_query_group.cu",
        "lion_tpu/ops/pallas/ball_query_group.py:283")
def ball_query_group_kernel(points_coords: torch.Tensor,
                     centers_coords: torch.Tensor,
                     points_features: torch.Tensor, radius: float,
                     num_neighbors: int) -> torch.Tensor:
    """points (B, N, 3), centers (B, M, 3) f32, features (B, N, C) f32 or
    bf16 -> (B, M, K, 3 + C) of the features' dtype: [center-relative xyz
    (fp32, rounded once) ++ features (exact)] per neighbour."""
    dt = check_float(points_features, "ball_query_group")
    check_cuda(points_coords, centers_coords)
    check_cuda(points_features, dtype=dt, device=points_coords.device)
    b, n, _ = points_coords.shape
    m = centers_coords.shape[1]
    c = points_features.shape[-1]
    k = num_neighbors
    cpb, threads, tile, _ = bqg_plan(b, n, m, c, k)
    out = torch.empty((b, m, k, 3 + c), dtype=dt, device=points_coords.device)
    launch("lion_ball_query_group", ptr(points_coords), ptr(centers_coords),
           ptr(points_features), ptr(out), b, n, m, c, k, _r2(radius),
           int(dt == torch.bfloat16), cpb, threads, tile,
           stream_of(points_coords))
    return out


class _BallQueryGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points_coords, centers_coords, points_features, radius,
                num_neighbors):
        ctx.save_for_backward(points_coords, centers_coords)
        ctx.radius, ctx.k = radius, num_neighbors
        ctx.n_feat = points_features.shape[-1]
        ctx.dtypes = (points_coords.dtype, centers_coords.dtype,
                      points_features.dtype)
        return ball_query_group_kernel(points_coords, centers_coords,
                                       points_features, radius,
                                       num_neighbors)

    @staticmethod
    def backward(ctx, g):
        points_coords, centers_coords = ctx.saved_tensors
        b, n, _ = points_coords.shape
        m, k = centers_coords.shape[1], ctx.k
        gp = gc = gf = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[2]:
            idx = ball_query(centers_coords, points_coords, ctx.radius,
                             k).reshape(b, m * k)
            # one fixed-order sum of the whole rows: the coordinates'
            # columns and the features' are summed apart, in the same order
            rows = scatter_rows(idx, g.reshape(b, m * k, 3 + ctx.n_feat), n)
            if ctx.needs_input_grad[0]:
                gp = rows[..., :3].to(ctx.dtypes[0])
            if ctx.needs_input_grad[2]:
                gf = rows[..., 3:].to(ctx.dtypes[2])
        if ctx.needs_input_grad[1]:
            gc = (-g[..., :3].float().sum(dim=2)).to(ctx.dtypes[1])
        return gp, gc, gf, None, None


def ball_query_group(points_coords: torch.Tensor,
                     centers_coords: torch.Tensor,
                     points_features: torch.Tensor, radius: float,
                     num_neighbors: int) -> torch.Tensor:
    """points (B, N, 3), centers (B, M, 3), features (B, N, C) ->
    (B, M, K, 3 + C): [center-relative xyz ++ features] per neighbour, with
    gradients to all three inputs."""
    return _BallQueryGroup.apply(points_coords, centers_coords,
                                 points_features, radius, num_neighbors)


# --------------------------------------------------------------------------
# K13: ball query + grouping, channel-first
# --------------------------------------------------------------------------
def _ball_query_group_cf_plain(points_coords, centers_coords,
                               points_features, radius: float,
                               num_neighbors: int):
    """The row layout's plain version in the features' dtype, permuted to
    (B, K, 3 + C, M)."""
    rows = _ball_query_group_plain(points_coords, centers_coords,
                                   points_features, radius, num_neighbors)
    return rows.to(points_features.dtype).permute(0, 2, 3, 1).contiguous()


@kernel("ball_query_group_cf", _ball_query_group_cf_plain,
        "lion_tpu_torch/csrc/ball_query_group_cf.cu",
        "lion_tpu/ops/pallas/ball_query_group.py:250")
def ball_query_group_cf_kernel(points_coords: torch.Tensor,
                               centers_coords: torch.Tensor,
                               points_features: torch.Tensor, radius: float,
                               num_neighbors: int) -> torch.Tensor:
    """points (B, N, 3), centers (B, M, 3) f32, features (B, N, C) f32 or
    bf16 -> (B, K, 3 + C, M) of the features' dtype."""
    dt = check_float(points_features, "ball_query_group_cf")
    check_cuda(points_coords, centers_coords)
    check_cuda(points_features, dtype=dt, device=points_coords.device)
    b, n, _ = points_coords.shape
    m = centers_coords.shape[1]
    c = points_features.shape[-1]
    k = num_neighbors
    cpb, groups, threads, tile, _ = bqg_cf_plan(
        b, n, m, c, k, points_features.element_size())
    out = torch.empty((b, k, 3 + c, m), dtype=dt, device=points_coords.device)
    launch("lion_ball_query_group_cf", ptr(points_coords), ptr(centers_coords),
           ptr(points_features), ptr(out), b, n, m, c, k, _r2(radius),
           int(dt == torch.bfloat16), cpb, groups, threads, tile,
           stream_of(points_coords))
    return out


class _BallQueryGroupCF(torch.autograd.Function):
    """Forward by K13; the backward permutes the gradient to the row layout
    and runs K2's backward (lion_tpu/ops/points.py:301-308)."""

    @staticmethod
    def forward(ctx, points_coords, centers_coords, points_features, radius,
                num_neighbors):
        ctx.save_for_backward(points_coords, centers_coords)
        ctx.radius, ctx.k = radius, num_neighbors
        ctx.n_feat = points_features.shape[-1]
        ctx.dtypes = (points_coords.dtype, centers_coords.dtype,
                      points_features.dtype)
        return ball_query_group_cf_kernel(points_coords, centers_coords,
                                          points_features, radius,
                                          num_neighbors)

    @staticmethod
    def backward(ctx, g):
        return _BallQueryGroup.backward(ctx, g.permute(0, 3, 1, 2))


def ball_query_group_cf(points_coords: torch.Tensor,
                        centers_coords: torch.Tensor,
                        points_features: torch.Tensor, radius: float,
                        num_neighbors: int) -> torch.Tensor:
    """Channel-first ball_query_group: points (B, N, 3), centers (B, M, 3),
    features (B, N, C) (required) -> (B, K, 3 + C, M), rows = [center-
    relative xyz ++ features], with gradients to all three inputs."""
    if points_features is None:
        raise ValueError("ball_query_group_cf requires features")
    return _BallQueryGroupCF.apply(points_coords, centers_coords,
                                   points_features, radius, num_neighbors)
