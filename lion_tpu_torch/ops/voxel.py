"""Voxelization / devoxelization ops (port of lion_tpu/ops/voxel.py).

Channels-last like the JAX package: grids are (B, R, R, R, C).

Kernels here:
  K3 `avg_voxelize` (csrc/voxelize.cu): scatter-mean of point features,
     as a stable cell order of the points (one block per item) and one
     write per output element; bit-reproducible, no zero fill.
  K5 `trilinear_devoxelize` (csrc/devoxelize.cu): 8-corner trilinear
     gather, a lane group a point (`devox_plan`), with an optional
     per-(item, channel) affine in its epilogue.
Both take float32 or bfloat16 features and emit their dtype. K3 sums in
float32 and rounds the mean once (lion_tpu/ops/voxel.py:61,92); K5 rounds
each corner weight to the grid's dtype, as the JAX form casts its weights
(voxel.py:249), accumulates the 8 products in float32 and rounds once.

`avg_voxelize` and `trilinear_devoxelize` have gradients to the features
and the grid, and none to the coordinates, as the JAX VJPs replay their
XLA forms (lion_tpu/ops/voxel.py:149-161,208-218): voxelize's is a gather
of g / count per point, devoxelize's the sum of the 8 weighted corners
into the grid's gradient, in a fixed order (`rows.scatter_rows`: float32,
rounded once to the grid's dtype). Both stay in fixed order through a
second derivative (`rows.gather_rows` and `scatter_rows` are each other's
gradient).

A cloud whose coordinates are not finite (a model whose latents
overflowed) normalizes to NaN. Its points land in voxel (0, 0, 0): XLA and
the card convert NaN to the integer 0, and K3's plain version and backward
read the x86 CPU's INT_MIN as 0. K5 and its plain version and backward
clamp each corner into the grid, as the kernel does: the loss turns
non-finite, as in the JAX package, and no index leaves the grid.
"""
from __future__ import annotations

import functools

import torch

from ._cuda import check_cuda, check_float, kernel, launch, ptr, stream_of
from .rows import SMEM_MAX  # noqa: F401 (K3's order shares the row sum's)
from .rows import gather_rows, order_smem, order_words, scatter_rows


def normalize_coords(coords: torch.Tensor, resolution: int) -> torch.Tensor:
    """coords (B, N, 3) -> continuous voxel coords (B, N, 3) in [0, r-1].

    Mean-centre each cloud, divide by twice the largest point norm, shift
    by 0.5, scale by r and clamp (models/pvcnn2.py Voxelization). The mean
    is summed in float64 and the norms op by op, so the result does not
    depend on a device's reduction order and a point rounds to the same
    voxel on the CPU and on the card."""
    coords = coords.detach().float()
    c = coords - coords.double().mean(dim=1, keepdim=True).float()
    norm = torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                      + c[..., 2] * c[..., 2])[..., None]
    normed = c / (norm.amax(dim=1, keepdim=True) * 2.0) + 0.5
    return torch.clamp(normed * resolution, 0.0, resolution - 1)


# --------------------------------------------------------------------------
# K3: average voxelization
# --------------------------------------------------------------------------
_NAN_AS_INT = torch.iinfo(torch.int32).min   # NaN converted on an x86 CPU


def _flat_cells(vox_coords: torch.Tensor, r: int) -> torch.Tensor:
    """The flat cell of each point, (B, N); a NaN coordinate converted on
    the CPU is read as 0, as XLA and the card convert it."""
    v = vox_coords.long()
    v = v.masked_fill(v == _NAN_AS_INT, 0)
    return (v[..., 0] * r + v[..., 1]) * r + v[..., 2]


def _avg_voxelize_plain(features: torch.Tensor, vox_coords: torch.Tensor,
                        resolution: int) -> torch.Tensor:
    b, _, c = features.shape
    r = resolution
    flat = _flat_cells(vox_coords, r)
    grid = features.new_zeros((b, r ** 3, c), dtype=torch.float32)
    grid.scatter_add_(1, flat[:, :, None].expand(-1, -1, c), features.float())
    count = grid.new_zeros((b, r ** 3))
    count.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.float32))
    grid = grid / count.clamp(min=1.0)[:, :, None]
    return grid.reshape(b, r, r, r, c).to(features.dtype)


def vox_order_smem(n: int, r: int) -> int:
    """Shared memory of K3's ordering launch (csrc/voxelize.cu
    vox_order_smem: the stable order of N points into r^3 cells), or 0
    when its words do not fit and live in a global scratch."""
    return order_smem(n, r ** 3)


@kernel("avg_voxelize", _avg_voxelize_plain,
        "lion_tpu_torch/csrc/voxelize.cu",
        "lion_tpu/ops/pallas/voxelize.py:107")
def avg_voxelize_kernel(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """features (B, N, C) f32 or bf16, vox_coords (B, N, 3) int32 in
    [0, r) -> (B, R, R, R, C) of the features' dtype; a point outside the
    grid is dropped. Two launches: the cell order (offsets (B, r^3 + 1),
    order (B, N)), then each output element written once."""
    dt = check_float(features, "avg_voxelize")
    check_cuda(features, dtype=dt)
    check_cuda(vox_coords, dtype=torch.int32)
    b, n, c = features.shape
    r = resolution
    dev = features.device
    if vox_coords.shape != (b, n, 3):
        raise ValueError(f"avg_voxelize: vox_coords {vox_coords.shape}")
    # one int32 scratch: offsets (B, r^3 + 1), order (B, N) and, when the
    # ordering launch's words do not fit in shared memory, their room
    words = b * (r ** 3 + 1 + n)
    extra = 0 if vox_order_smem(n, r) else b * order_words(n, r ** 3)
    scratch = torch.empty(words + extra, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    out = torch.empty((b, r, r, r, c), dtype=dt, device=dev)
    launch("lion_avg_voxelize", ptr(features), ptr(vox_coords), base,
           base + 4 * b * (r ** 3 + 1), base + 4 * words if extra else None,
           ptr(out), b, n, c, r, int(dt == torch.bfloat16),
           stream_of(features))
    return out


class _AvgVoxelize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, vox_coords, resolution):
        ctx.save_for_backward(vox_coords)
        ctx.r, ctx.dtype = resolution, features.dtype
        return avg_voxelize_kernel(features, vox_coords, resolution)

    @staticmethod
    def backward(ctx, g):
        (vox_coords,) = ctx.saved_tensors
        r = ctx.r
        b, c = g.shape[0], g.shape[-1]
        flat = _flat_cells(vox_coords, r)
        count = torch.zeros((b, r ** 3), device=g.device).scatter_add_(
            1, flat, torch.ones_like(flat, dtype=torch.float32))
        rows = gather_rows(g.reshape(b, r ** 3, c).float(), flat)
        gf = rows / torch.gather(count, 1, flat)[:, :, None]
        return gf.to(ctx.dtype), None, None


def avg_voxelize(features: torch.Tensor, vox_coords: torch.Tensor,
                 resolution: int) -> torch.Tensor:
    """features (B, N, C), vox_coords (B, N, 3) int32 in [0, r) ->
    (B, R, R, R, C), with a gradient to the features."""
    return _AvgVoxelize.apply(features, vox_coords, resolution)


def voxelize(features: torch.Tensor, coords: torch.Tensor, resolution: int):
    """features (B, N, C), coords (B, N, 3) ->
    (grid (B, R, R, R, C), norm_coords (B, N, 3) in [0, r-1])."""
    norm_coords = normalize_coords(coords, resolution)
    # torch.round rounds half to even, like jnp.round
    vox_coords = torch.round(norm_coords).to(torch.int32)
    return (avg_voxelize(features.contiguous(), vox_coords, resolution),
            norm_coords)


# --------------------------------------------------------------------------
# K5: trilinear devoxelization
# --------------------------------------------------------------------------
def _corners(norm_coords: torch.Tensor, r: int, dtype: torch.dtype):
    """The 8 trilinear corners of each point, in the order (dx, dy, dz) =
    (0,0,0), (0,0,1), ..., (1,1,1): flat cell indices (B, N) and weights
    (B, N) (wx * wy) * wz rounded to `dtype`, as float32."""
    coords = norm_coords.detach().float()
    lo = torch.floor(coords)
    frac = coords - lo
    # clamped into the grid as the kernel clamps (a no-op for the finite
    # coordinates normalize_coords gives); hi collapses onto lo when
    # frac == 0
    lo_i = lo.long().clamp(0, r - 1)
    hi_i = (lo_i + (frac > 0).long()).clamp(max=r - 1)
    out = []
    for dx in (0, 1):
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        ix = hi_i[..., 0] if dx else lo_i[..., 0]
        for dy in (0, 1):
            wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
            iy = hi_i[..., 1] if dy else lo_i[..., 1]
            for dz in (0, 1):
                wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
                iz = hi_i[..., 2] if dz else lo_i[..., 2]
                out.append(((ix * r + iy) * r + iz,
                            (wx * wy * wz).to(dtype).float()))
    return out


def _trilinear_devoxelize_plain(grid: torch.Tensor, norm_coords: torch.Tensor,
                                resolution: int, scale=None,
                                bias=None) -> torch.Tensor:
    r = resolution
    b, c = grid.shape[0], grid.shape[-1]
    flat_grid = grid.reshape(b, r ** 3, c)
    out = torch.zeros((b, norm_coords.shape[1], c), device=grid.device)
    for idx, w in _corners(norm_coords, r, grid.dtype):
        corner = torch.gather(flat_grid, 1, idx[:, :, None].expand(-1, -1, c))
        out = out + corner.float() * w[:, :, None]
    if scale is not None:
        out = out * scale[:, None, :] + bias[:, None, :]
    return out.to(grid.dtype)


# K5's plan limits (csrc/devoxelize.cu kMaxThreads; a warp; the H100's SMs)
DEVOX_MAX_THREADS, DEVOX_MAX_LANES, DEVOX_MIN_BLOCKS = 256, 32, 132


@functools.lru_cache(maxsize=None)
def devox_plan(b: int, n: int, c: int, elem: int):
    """(threads a block, lanes a point) of K5 for B clouds of N points with
    C channels of `elem` bytes. A lane sums 16 bytes of channels a step
    (one channel when C * elem is not a multiple of 16); a point takes the
    fewest lanes (a power of two, at most a warp) that cover its row in one
    step, then the most threads (a power of two from 32 to
    DEVOX_MAX_THREADS) whose blocks still number DEVOX_MIN_BLOCKS."""
    vec = 16 // elem if c * elem % 16 == 0 else 1
    lanes = 1
    while lanes < DEVOX_MAX_LANES and lanes * vec < c:
        lanes *= 2
    threads = DEVOX_MAX_THREADS
    while threads > 32 and -(-b * n * lanes // threads) < DEVOX_MIN_BLOCKS:
        threads //= 2
    return threads, lanes


@kernel("trilinear_devoxelize", _trilinear_devoxelize_plain,
        "lion_tpu_torch/csrc/devoxelize.cu",
        "lion_tpu/ops/pallas/devox.py:117")
def trilinear_devoxelize_kernel(grid: torch.Tensor, norm_coords: torch.Tensor,
                                resolution: int, scale=None,
                                bias=None) -> torch.Tensor:
    """grid (B, R, R, R, C) f32 or bf16, norm_coords (B, N, 3) f32 ->
    (B, N, C) of the grid's dtype. With `scale` and `bias` (B, C) f32 the
    float32 sum becomes sum * scale + bias before its one rounding."""
    dt = check_float(grid, "trilinear_devoxelize")
    check_cuda(grid, dtype=dt)
    check_cuda(norm_coords, scale, bias, device=grid.device)
    b, c = grid.shape[0], grid.shape[-1]
    n = norm_coords.shape[1]
    if (scale is None) != (bias is None) or scale is not None and not (
            scale.shape == bias.shape == (b, c)):
        raise ValueError(f"trilinear_devoxelize: scale and bias must both "
                         f"be (B, C) = {(b, c)} or both be absent")
    out = torch.empty((b, n, c), device=grid.device, dtype=dt)
    threads, lanes = devox_plan(b, n, c, grid.element_size())
    launch("lion_trilinear_devoxelize", ptr(grid), ptr(norm_coords),
           ptr(scale), ptr(bias), ptr(out), b, n, c, resolution,
           int(dt == torch.bfloat16), threads, lanes.bit_length() - 1,
           stream_of(grid))
    return out


class _TrilinearDevoxelize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, norm_coords, resolution):
        ctx.save_for_backward(norm_coords)
        ctx.r, ctx.dtype = resolution, grid.dtype
        return trilinear_devoxelize_kernel(grid, norm_coords, resolution)

    @staticmethod
    def backward(ctx, g):
        (norm_coords,) = ctx.saved_tensors
        r = ctx.r
        b, n, c = g.shape
        corners = _corners(norm_coords, r, ctx.dtype)
        idx = torch.cat([i for i, _ in corners], dim=1)       # (B, 8N)
        w = torch.cat([w for _, w in corners], dim=1)
        rows = g.float().repeat(1, 8, 1) * w[:, :, None]
        grad = scatter_rows(idx, rows, r ** 3)
        return grad.reshape(b, r, r, r, c).to(ctx.dtype), None, None


def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         resolution: int, scale=None,
                         bias=None) -> torch.Tensor:
    """grid (B, R, R, R, C), norm_coords (B, N, 3) -> (B, N, C), with a
    gradient to the grid. With `scale` and `bias` (B, C) f32, the per-(item,
    channel) affine sum * scale + bias applied before the one rounding to
    the grid's dtype, and no gradient (PVConv's eval flow, whose convs have
    none either)."""
    if scale is None and bias is None:
        return _TrilinearDevoxelize.apply(grid, norm_coords, resolution)
    with torch.no_grad():
        return trilinear_devoxelize_kernel(grid, norm_coords, resolution,
                                           scale, bias)
