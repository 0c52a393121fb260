"""3-nearest-neighbour inverse-distance interpolation (port of
lion_tpu/ops/interpolate.py).

Kernel here:
  K6 `three_nn_interpolate` (csrc/three_nn.cu), which can also return each
     point's neighbour indices and weights. `three_nn_plan` sizes its
     blocks.

`nearest_neighbor_interpolate` has a gradient to the centers' features
only, as the JAX VJP (lion_tpu/ops/interpolate.py:51-81): the sum of
g * w into each center through the (idx, w) that the forward returned,
with no distance matrix, in a fixed order (`rows.scatter_rows`: float32,
rounded once to the features' dtype).

The plain version evaluates the distances and the weighted sum op by op in
the order the kernel uses with unfused arithmetic, so both pick the same
neighbours and agree bit for bit on the card. Features may be float32 or
bfloat16; the output takes their dtype. With bfloat16 features the three
weights are rounded to bfloat16, as the JAX form casts them
(lion_tpu/ops/interpolate.py:98), and the weighted sum is taken in float32
and rounded once.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, check_float, kernel, launch, ptr, stream_of
from .rows import scatter_rows


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def pairwise_sqdist(points: torch.Tensor, centers: torch.Tensor):
    """(B, N, 3), (B, M, 3) -> (B, N, M): max((|p|^2 + |c|^2) - 2 p.c, 0),
    the matmul form the JAX package uses."""
    p = points.float()[:, :, None, :]
    c = centers.float()[:, None, :, :]
    dot = p[..., 0] * c[..., 0] + p[..., 1] * c[..., 1] + p[..., 2] * c[..., 2]
    p2 = _sq_norm(points.float())[:, :, None]
    c2 = _sq_norm(centers.float())[:, None, :]
    return torch.clamp_min((p2 + c2) - 2.0 * dot, 0.0)


def three_nn(points: torch.Tensor, centers: torch.Tensor):
    """points (B, N, 3), centers (B, M, 3) -> (d2 (B, N, 3), idx (B, N, 3)).

    Three masked argmin sweeps; ties go to the lowest index. With M < 3 the
    missing slots get index 0 and d2 = 1e10 (the CUDA initializer)."""
    d2 = pairwise_sqdist(points, centers)
    m = d2.shape[-1]
    dists, idxs = [], []
    work = d2
    for j in range(3):
        if j < m:
            idx_j = torch.argmin(work, dim=-1)
            d_j = torch.gather(work, -1, idx_j[..., None])[..., 0]
            if j < 2:
                work = work.scatter(-1, idx_j[..., None], float("inf"))
        else:
            idx_j = torch.zeros(d2.shape[:2], dtype=torch.long,
                                device=d2.device)
            d_j = torch.full(d2.shape[:2], 1e10, device=d2.device)
        dists.append(d_j)
        idxs.append(idx_j)
    return torch.stack(dists, -1), torch.stack(idxs, -1)


# K6's limits (csrc/three_nn.cu, whose constants these equal): threads a
# block, lanes a point, centers a shared-memory tile, centers a lane takes
# a step, output chunks in flight a thread. The plan's targets: B N L
# threads in all (about 15 resident warps an SM on the H100's 132 SMs) and
# a full wave of blocks.
THREE_NN_MAX_THREADS, THREE_NN_MAX_LANES = 256, 32
THREE_NN_TILE, THREE_NN_GROUP, THREE_NN_UNROLL = 1024, 4, 2
THREE_NN_FILL_THREADS, THREE_NN_MIN_BLOCKS = 1 << 16, 132


def three_nn_plan(b: int, n: int):
    """(threads a block, lanes a point) of K6 for B clouds of N points: the
    fewest lanes (a power of two, at most a warp) that give B N L >=
    THREE_NN_FILL_THREADS threads, then the most threads (a power of two
    from 32 to THREE_NN_MAX_THREADS) whose blocks of threads / L points
    still number THREE_NN_MIN_BLOCKS. A lane scans M / L centers (none
    when L > M), so the plan needs no M."""
    lanes = 1
    while lanes < THREE_NN_MAX_LANES and b * n * lanes < THREE_NN_FILL_THREADS:
        lanes *= 2
    threads = THREE_NN_MAX_THREADS
    while threads > 32 and -(-n * lanes // threads) * b < THREE_NN_MIN_BLOCKS:
        threads //= 2
    return threads, lanes


def _three_nn_interpolate_plain(points, centers, centers_features,
                                with_weights: bool = False):
    d2, idx = three_nn(points, centers)
    d2 = torch.clamp(d2, 1e-10, 1e10)
    d0, d1, d2_ = d2[..., 0], d2[..., 1], d2[..., 2]
    d0d1, d0d2, d1d2 = d0 * d1, d0 * d2_, d1 * d2_
    inv = 1.0 / (d0d1 + d0d2 + d1d2)
    dt = centers_features.dtype
    feats = centers_features.float()
    c = feats.shape[-1]
    ws = [w.to(dt).float() for w in (d1d2 * inv, d0d2 * inv, d0d1 * inv)]
    out = None
    for j, w in enumerate(ws):
        f = torch.gather(feats, 1, idx[..., j:j + 1].expand(-1, -1, c))
        term = f * w[..., None]
        out = term if out is None else out + term
    out = out.to(dt)
    if not with_weights:
        return out
    return out, idx.to(torch.int32), torch.stack(ws, dim=-1)


@kernel("three_nn_interpolate", _three_nn_interpolate_plain,
        "lion_tpu_torch/csrc/three_nn.cu",
        "lion_tpu/ops/pallas/three_nn.py:74")
def three_nn_interpolate(points: torch.Tensor, centers: torch.Tensor,
                         centers_features: torch.Tensor,
                         with_weights: bool = False):
    """points (B, N, 3), centers (B, M, 3) f32, centers_features (B, M, C)
    f32 or bf16 -> (B, N, C) of the features' dtype; with `with_weights`
    also idx (B, N, 3) int32 and w (B, N, 3) f32, the three neighbours and
    their weights as used (rounded to the features' dtype)."""
    dt = check_float(centers_features, "nearest_neighbor_interpolate")
    check_cuda(points, centers)
    check_cuda(centers_features, dtype=dt)
    b, n, _ = points.shape
    m, c = centers_features.shape[1], centers_features.shape[2]
    if m < 1:
        raise ValueError("nearest_neighbor_interpolate needs M >= 1")
    out = torch.empty((b, n, c), device=points.device, dtype=dt)
    idx = w = None
    if with_weights:
        idx = torch.empty((b, n, 3), dtype=torch.int32, device=points.device)
        w = torch.empty((b, n, 3), device=points.device)
    launch("lion_three_nn_interpolate", ptr(points), ptr(centers),
           ptr(centers_features), ptr(out), ptr(idx), ptr(w), b, n, m, c,
           int(dt == torch.bfloat16), *three_nn_plan(b, n), stream_of(points))
    return (out, idx, w) if with_weights else out


class _NearestNeighborInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, centers, centers_features):
        ctx.m, ctx.dtype = centers_features.shape[1], centers_features.dtype
        if not ctx.needs_input_grad[2]:
            return three_nn_interpolate(points, centers, centers_features)
        out, idx, w = three_nn_interpolate(points, centers, centers_features,
                                           with_weights=True)
        ctx.save_for_backward(idx, w)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        b, n, c = g.shape
        rows = (g.float()[:, :, None, :] * w[..., None]).reshape(b, n * 3, c)
        gf = scatter_rows(idx.reshape(b, n * 3), rows, ctx.m)
        return None, None, gf.to(ctx.dtype)


def nearest_neighbor_interpolate(points: torch.Tensor, centers: torch.Tensor,
                                 centers_features: torch.Tensor):
    """points (B, N, 3), centers (B, M, 3), centers_features (B, M, C) ->
    (B, N, C), with a gradient to the centers' features."""
    return _NearestNeighborInterpolate.apply(points, centers,
                                             centers_features)
