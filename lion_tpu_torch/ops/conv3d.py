"""3x3x3 SAME convolutions (ports of conv3d_3x3_fused,
lion_tpu/ops/pallas/conv3d.py:441-474, conv3d_3x3_same, :556-604, and
conv3d_packed_pair, lion_tpu/ops/pallas/conv3d_packed.py:608).

Kernels here:
  K4 `conv3d_3x3_fused` (csrc/conv3d.cu): one conv with an input prologue
     and output statistics, in float32 or bfloat16.
  K8 `conv3d_pair` (csrc/conv3d_pair.cu): conv0 -> GroupNorm fold ->
     swish -> conv1 of a PVConv whose input width equals its output width.
  K10 `conv3d_3x3_same` (csrc/conv3d.cu): the training conv, bias-free,
     in float32 (exact FFMA) or bfloat16 (wgmma, products summed in
     float32, y rounded once), with a gradient (`conv3d_3x3_same`): dL/dx
     is K10 again on the output gradient with flipped, channel-transposed
     weights in the gradient's dtype, as the JAX VJP computes it
     (conv3d.py:589-593); dL/dw is K10's weight gradient below.
  `conv3d_weight_grad` (csrc/conv3d_wgrad.cu): dL/dw of K10 in exact fp32
     FFMA from x and g (bf16 widened in registers), summed in a fixed order
     and rounded to w's dtype as the JAX VJP rounds it (conv3d.py:594-600),
     where the JAX package leaves it to XLA. It repeats bit for bit: the
     long sum over the voxels is split into slabs by the shape alone
     (`wgrad_plan`) and the slabs' partials are summed in slab order.

K4: y = conv3d_SAME(swish?(x * in_scale + in_bias), w), bias-free, plus the
per-channel statistics stats[b] = (sum of y, sum of y^2) over the grid, which
the caller folds with the conv bias into the next GroupNorm. The prologue
applies to in-grid inputs only: the zero halo is added after it. With
bfloat16 x and w the prologue runs in float32 and is rounded to bfloat16
(ops/pallas/conv3d.py:460-468), the products are summed in float32, y is
rounded to bfloat16 and the statistics are taken of the rounded y, as the
TPU kernels take them (conv3d_packed.py:466-472).
The statistics are summed in a fixed order (per-warp slots, then one
partial per block in a (B, bricks, 2, Co) scratch, merged by each item's
last block behind an integer ticket; csrc/conv_brick.cuh: flush_stats), so
K4 and K8 repeat bit for bit.
K4 and K8 are inference only: no gradient.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ._cuda import check_cuda, check_float, kernel, launch, ptr, stream_of

GN_GROUPS, GN_EPS = 8, 1e-5

# The halo-brick kernels of K4 and K10 (csrc/conv_brick.cuh): shared memory
# a block may use on the H100 and an SM holds (1 KB of it reserved per
# block), the kernels' static shared memory (the statistics merge's flag,
# padded), its SM count, and the (bn, tile) pairs the kernels are compiled
# for, all on 256 threads. bf16 (wgmma): 64 channels (wgmma's M), tile =
# planes of 8 x 8 voxels per warpgroup, a brick of 2 tile x 8 x 8 voxels.
# fp32: tile = voxels per thread (a run along w), 8 channels each,
# tile * 2048 / bn voxels. (The plan never chose wider tiles at any shape.)
SMEM_BYTES, SMEM_SM = 232448, 233472
SMEM_STATIC = 16
SMS = 132
# the widest K8 takes (its wrapper's contract)
PAIR_MAX_C = 256
_BF16_TILES = ((64, 4), (64, 2), (64, 1))
_FP32_TILES = ((64, 2), (32, 8), (32, 4), (32, 2))


class ConvPlan(NamedTuple):
    """How the brick kernel covers one conv: blocks of `brick` (d, h, w)
    output voxels of one item by `bn` output channels (grid: bricks, output
    channel tiles, items) on `threads` threads, registers kept for
    `min_blocks` such blocks of 256 threads per SM, `kc` input channels per
    staged chunk (padded in shared memory), `taps` taps per weight stage,
    the shared-memory row pitches in elements and the dynamic shared-memory
    bytes; `ldw` is the weights' row length, Co padded to 16 bytes."""
    brick: Tuple[int, int, int]
    bn: int
    tile: int
    threads: int
    min_blocks: int
    kc: int
    taps: int
    hpitch: int
    wpitch: int
    ldw: int
    smem: int
    grid: Tuple[int, int, int]


def _odd_units(n: int, vec: int) -> int:
    """n elements rounded up to an odd number of 16-byte units of `vec`
    elements: 8 consecutive rows then start in 8 different bank groups."""
    return ((-(-n // vec)) | 1) * vec


@functools.lru_cache(maxsize=None)
def _brick(bm: int, r: int, run: int):
    """The fp32 kernel's (d, h, w) brick of bm voxels (powers of two, w a
    multiple of a thread's `run`) that wastes the fewest products on voxels
    outside the grid, then has w = 8 (the runs of a warp's lanes start on
    distinct banks), then stages the fewest halo cells."""
    sizes = [1 << i for i in range(bm.bit_length())]

    def cost(br):
        nb = math.prod(-(-r // s) for s in br)
        return (nb * bm, br[2] != 8, nb * math.prod(s + 2 for s in br),
                -br[2])
    return min((br for br in itertools.product(sizes, repeat=3)
                if math.prod(br) == bm and br[2] % run == 0), key=cost)


@functools.lru_cache(maxsize=None)
def conv_plan(b: int, r: int, ci: int, co: int,
              dtype: torch.dtype) -> ConvPlan:
    """The brick kernel's plan for a (b, r, ci, co) conv in `dtype`.

    Chunks: bf16 stages 16 channels when ci <= 16 (the fragment depth) and
    32 otherwise; fp32 stages 4 channels when ci <= 4 (so a weight stage of
    27 taps x 4 channels is one K run, not 3/4 zeros), 8 when ci <= 8 and 16
    otherwise: a power of two, as the kernel's index shifts need. A weight
    stage holds 27, 9 or 3 taps, the most that fit in 288 rows and in shared
    memory. A bf16 conv of one chunk keeps registers for two blocks per SM
    where its accumulators allow, so that one block's staging overlaps
    another's products.

    Among the compiled tiles, the plan takes the one that gives at least a
    block per two SMs, then two blocks per SM, then the fewest staged
    elements (halo cells and weights) per output: the order that picked
    the fastest tile at every main-path shape on the H100. Cached: the
    wrapper asks at every call."""
    bf = dtype == torch.bfloat16
    esize = 2 if bf else 4
    vec = 16 // esize
    if bf:
        kc = 16 if ci <= 16 else 32
    else:
        kc = next(k for k in (4, 8, 16) if ci <= k or k == 16)
    chunks = -(-ci // kc)
    # bf16: the halo in K-major core matrices, no row padding
    hpitch = kc if bf else _odd_units(kc, vec)
    ldw = -(-co // vec) * vec
    best = None
    for bn, tile in (_BF16_TILES if bf else _FP32_TILES):
        if not bf and bn == 64 and ldw <= 32:
            continue                       # a narrower tile covers co
        if bf:
            bm, brick, wpitch = 128 * tile, (2 * tile, 8, 8), bn
            # two blocks per SM fit in registers up to 64 accumulators
            min_blocks = 2 if chunks == 1 and tile <= 2 else 1
        else:
            bm = tile * 2048 // bn
            brick, wpitch, min_blocks = _brick(bm, r, tile), bn, 1
        cells = math.prod(s + 2 for s in brick)
        limit = min(SMEM_BYTES, SMEM_SM // min_blocks - 1024) - SMEM_STATIC
        for taps in (27, 9, 3):
            steps = chunks * 27 // taps
            smem = esize * (min(2, chunks) * cells * hpitch
                            + min(2, steps) * taps * kc * wpitch) + 4 * cells
            if taps * kc <= 288 and smem <= limit:
                break
        else:
            continue
        grid = (math.prod(-(-r // s) for s in brick), -(-co // bn), b)
        staged = chunks * kc * (27 * bn + cells) / (bm * bn)
        key = (min(math.prod(grid), SMS // 2), min_blocks, -staged)
        if best is None or key > best[0]:
            best = (key, ConvPlan(brick, bn, tile, 256, min_blocks, kc, taps,
                                  hpitch, wpitch, ldw, smem, grid))
    return best[1]


# K10's weight gradient (csrc/conv3d_wgrad.cu): the brick a block stages
# (d, h, w; a thread's runs lie along w), the (kc, bn) channel tiles it is
# compiled for, on 256 threads (a thread: one input channel by 4 output
# channels for all 27 taps), the blocks a launch aims at (two rounds of one
# block per SM on the H100: one register set fills an SM) and the cap on
# the slabs' partials. Both fix the slabs, and so the order of dw's sums,
# from the shape alone, on every card.
WGRAD_BRICK = (4, 4, 8)
_WGRAD_TILES = ((16, 64), (32, 32), (8, 32), (4, 32))
WGRAD_THREADS = 256
WGRAD_BLOCKS = 264
WGRAD_SCRATCH = 32 << 20


class WgradPlan(NamedTuple):
    """How the weight-gradient kernel covers one (b, r, ci, co) problem:
    blocks of `kc` input by `bn` output channels, each channel tile split
    into `streams` groups of warps that walk alternate runs of a brick; the
    (item, brick) pairs, item-major, cut into `slabs` runs of `per_slab`
    (the last may be shorter), one block per (channel tile, slab) (`grid`);
    `smem` the dynamic shared memory, `scratch` the slabs' partials'
    bytes."""
    kc: int
    bn: int
    streams: int
    pairs: int
    slabs: int
    per_slab: int
    grid: Tuple[int, int]
    smem: int
    scratch: int


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, r: int, ci: int, co: int,
               dtype: torch.dtype) -> WgradPlan:
    """The weight-gradient kernel's plan for x (b, r, r, r, ci) and g
    (b, r, r, r, co) in `dtype`.

    The tile wastes the fewest products on channels past ci and co, then
    stages the fewest elements a product (halo cells x kc plus voxels x bn
    over kc x bn). The slabs: as many as give at most WGRAD_BLOCKS blocks,
    their partials within WGRAD_SCRATCH bytes, and no slab empty. Nothing
    here reads the card, so the sums' order depends on the shape alone.
    Cached: the wrapper asks at every call."""
    esize = 2 if dtype == torch.bfloat16 else 4
    cells = math.prod(s + 2 for s in WGRAD_BRICK)
    vox = math.prod(WGRAD_BRICK)

    def cost(t):
        kc, bn = t
        padded = -(-ci // kc) * kc * (-(-co // bn)) * bn
        return padded, (cells * kc + vox * bn) / (kc * bn)
    kc, bn = min(_WGRAD_TILES, key=cost)
    lanes = kc * bn // 4
    streams = WGRAD_THREADS // lanes
    tiles = -(-ci // kc) * (-(-co // bn))
    pairs = b * math.prod(-(-r // s) for s in WGRAD_BRICK)
    partial = 4 * 27 * ci * co
    slabs = max(1, min(WGRAD_BLOCKS // tiles, WGRAD_SCRATCH // partial,
                       pairs))
    per_slab = -(-pairs // slabs)
    slabs = -(-pairs // per_slab)
    staging = 2 * esize * (cells * kc + vox * bn)
    merge = 4 * (streams - 1) * 4 * 27 * lanes
    return WgradPlan(kc, bn, streams, pairs, slabs, per_slab,
                     (tiles, slabs), max(staging, merge), slabs * partial)


# (device, stream) -> the int32 tickets of the statistics' merge
_TICKETS = {}


def stats_tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least n zero int32 tickets for the brick kernels on the current
    stream of `device`. The block that takes an item's last ticket resets
    it, so the tickets are zero again whenever a launch has ended: they are
    zeroed once, not before each launch. One set per stream, since launches
    on one stream run one after another."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def stats_scratch(p: ConvPlan, co: int, device: torch.device):
    """The statistics merge's scratch for plan p: each block's partial
    (B, bricks, 2, co) f32 (not zeroed: every block writes its own) and
    the tickets of the (item, channel tile)s."""
    b = p.grid[2]
    part = torch.empty((b, p.grid[0], 2, co), device=device)
    return part, stats_tickets(device, b * p.grid[1])


def _launch_brick(x, w, scale, shift, y, stats, pre_swish):
    """Launch the brick kernel (csrc/conv3d.cu) on its plan."""
    b, r, ci, co = x.shape[0], x.shape[1], w.shape[3], w.shape[4]
    p = conv_plan(b, r, ci, co, x.dtype)
    w = w.reshape(27, ci, co)
    if p.ldw != co:                        # rows of 16 bytes
        w = F.pad(w, (0, p.ldw - co)).contiguous()
    part, tickets = (None, None) if stats is None else \
        stats_scratch(p, co, x.device)
    launch("lion_conv3d_brick", ptr(x), ptr(w), ptr(scale), ptr(shift),
           ptr(y), ptr(stats), ptr(part), ptr(tickets), b, r, ci, co, p.ldw,
           int(x.dtype == torch.bfloat16), int(pre_swish), *p.brick, p.bn,
           p.tile, p.min_blocks, p.kc, p.taps, p.hpitch, p.wpitch, p.smem,
           stream_of(x))


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
    xx = xx.to(x.dtype).float()
    y = F.conv3d(xx.permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 padding=1)
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()
    yf = y.float()
    stats = torch.stack([yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))],
                        dim=1)
    return y, stats


@kernel("conv3d_3x3_fused", _conv3d_3x3_fused_plain,
        "lion_tpu_torch/csrc/conv3d.cu",
        "lion_tpu/ops/pallas/conv3d.py:441")
def conv3d_3x3_fused(x: torch.Tensor, w: torch.Tensor,
                     in_scale: Optional[torch.Tensor] = None,
                     in_bias: Optional[torch.Tensor] = None,
                     pre_swish: bool = False):
    """x (B, R, R, R, Ci), w (3, 3, 3, Ci, Co) of one dtype (f32 or bf16),
    in_scale/in_bias (B, Ci) f32 or None -> (y (B, R, R, R, Co) of x's
    dtype, stats (B, 2, Co) f32)."""
    if (in_scale is None) != (in_bias is None):
        raise ValueError("in_scale and in_bias go together")
    dt = check_float(x, "conv3d_3x3_fused")
    check_cuda(x, w, dtype=dt)
    check_cuda(in_scale, in_bias, device=x.device)
    b, r = x.shape[0], x.shape[1]
    ci, co = w.shape[3], w.shape[4]
    if x.shape[1:] != (r, r, r, ci) or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"conv3d_3x3_fused: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    y = torch.empty((b, r, r, r, co), device=x.device, dtype=dt)
    stats = torch.empty((b, 2, co), device=x.device)
    _launch_brick(x, w, in_scale, in_bias, y, stats, pre_swish)
    return y, stats


def _conv3d_3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """In float32, rounded once to x's dtype (the XLA form's
    preferred_element_type, conv3d.py:575-579)."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 w.float().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


@kernel("conv3d_3x3_same", _conv3d_3x3_same_plain,
        "lion_tpu_torch/csrc/conv3d.cu",
        "lion_tpu/ops/pallas/conv3d.py:557")
def conv3d_3x3_same_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, R, Ci), w (3, 3, 3, Ci, Co) of one dtype (f32 or bf16)
    -> (B, R, R, R, Co) of that dtype, bias-free: the brick's fp32 tile,
    or its bf16 wgmma tile without prologue or statistics."""
    dt = check_float(x, "conv3d_3x3_same")
    check_cuda(x, w, dtype=dt)
    b, r = x.shape[0], x.shape[1]
    ci, co = w.shape[3], w.shape[4]
    if x.shape[1:] != (r, r, r, ci) or w.shape[:3] != (3, 3, 3):
        raise ValueError(f"conv3d_3x3_same: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    y = torch.empty((b, r, r, r, co), device=x.device, dtype=dt)
    _launch_brick(x, w, None, None, y, None, False)
    return y


def _conv3d_weight_grad_plain(x: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """In float32 from float32 copies of x and g, rounded once to x's
    dtype."""
    ci, co = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.float().permute(0, 4, 1, 2, 3), (co, ci, 3, 3, 3),
        g.float().permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0).to(x.dtype).contiguous()


@kernel("conv3d_weight_grad", _conv3d_weight_grad_plain,
        "lion_tpu_torch/csrc/conv3d_wgrad.cu",
        "none (XLA's convolution: lion_tpu/ops/pallas/conv3d.py:594)")
def conv3d_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, R, Ci), g (B, R, R, R, Co) of one dtype (f32 or bf16) ->
    dw (3, 3, 3, Ci, Co) of that dtype, the weight gradient of K10's
    bias-free SAME conv: a tile kernel writes each slab's partial
    (`wgrad_plan`) and a second kernel sums them in slab order."""
    dt = check_float(x, "conv3d_weight_grad")
    check_cuda(x, g, dtype=dt)
    b, r, ci, co = x.shape[0], x.shape[1], x.shape[4], g.shape[4]
    if x.shape[1:] != (r, r, r, ci) or g.shape[:4] != x.shape[:4]:
        raise ValueError(f"conv3d_weight_grad: x {tuple(x.shape)}, "
                         f"g {tuple(g.shape)}")
    p = wgrad_plan(b, r, ci, co, dt)
    part = torch.empty(p.scratch // 4, device=x.device)
    dw = torch.empty((3, 3, 3, ci, co), device=x.device, dtype=dt)
    launch("lion_conv3d_wgrad", ptr(x), ptr(g), ptr(part), ptr(dw), b, r,
           ci, co, int(dt == torch.bfloat16), p.kc, p.bn, p.slabs,
           p.per_slab, p.smem, stream_of(x))
    return dw


class _Conv3dWeightGrad(torch.autograd.Function):
    """dL/dw of K10 with its own gradient, so that a backward taken with
    create_graph stays differentiable through dw. dw is bilinear in x and
    g: for a cotangent v of dw, g's gradient is K10(x, v) and x's is
    K10(g, v flipped over the taps with Ci and Co swapped), the form dx
    takes; both go through _Conv3dSame for the orders above."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.save_for_backward(x, g)
        return conv3d_weight_grad(x, g)

    @staticmethod
    def backward(ctx, v):
        x, g = ctx.saved_tensors
        v = v.contiguous()
        gx = gg = None
        if ctx.needs_input_grad[0]:
            gx = _Conv3dSame.apply(
                g, v.flip(0, 1, 2).transpose(3, 4).contiguous())
        if ctx.needs_input_grad[1]:
            gg = _Conv3dSame.apply(x, v)
        return gx, gg


class _Conv3dSame(torch.autograd.Function):
    """K10 with its gradient. dx is K10 again on the flipped, transposed
    kernel, called through this Function so that a backward taken with
    create_graph (the Jacobian regularizer's J^T v) is itself
    differentiable: the kernel's raw launch is invisible to autograd, and
    a direct call would drop every second-order term through the conv.
    dw is the weight-gradient kernel, through _Conv3dWeightGrad for the
    same reason, in w's dtype (x's)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_3x3_same_kernel(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w_flip = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            dx = _Conv3dSame.apply(g, w_flip)
        if ctx.needs_input_grad[1]:
            dw = _Conv3dWeightGrad.apply(x, g)
        return dx, dw


def conv3d_3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The training conv with its gradient: x (B, R, R, R, Ci),
    w (3, 3, 3, Ci, Co) of one dtype (f32 or bf16) -> (B, R, R, R, Co) of
    that dtype, bias-free."""
    return _Conv3dSame.apply(x.contiguous(), w.contiguous())


def gn_affine_from_stats(s1, s2, count, ca, cb, pre_bias=None):
    """Fold GroupNorm(8) into per-channel (scale, bias) from raw statistics.

    s1/s2 (B, C): per-channel sum and sum of squares of the raw tensor y
    over `count` spatial elements; pre_bias (C,) is added to y before the
    norm (the conv bias); (ca, cb) (C,) or (B, C) is the affine after the
    parameter-free norm GN0. Returns (scale, bias) (B, C) with
    GN0(y + pre_bias) * ca + cb == scale * y + bias: groups of 8,
    var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5 (lion_tpu/nn/common.py:
    242-271 and the TPU conv pair's fold, conv3d_packed.py:537-562)."""
    b, c = s1.shape
    mean_c = s1 / count
    ex2_c = s2 / count
    if pre_bias is not None:
        # E[(y+b)^2] = E[y^2] + 2 b E[y] + b^2
        ex2_c = ex2_c + 2.0 * pre_bias * mean_c + pre_bias * pre_bias
        mean_c = mean_c + pre_bias
    per = c // GN_GROUPS
    gmean = mean_c.reshape(b, GN_GROUPS, per).mean(dim=2)
    gex2 = ex2_c.reshape(b, GN_GROUPS, per).mean(dim=2)
    gvar = torch.clamp_min(gex2 - gmean * gmean, 0.0)
    rs_c = torch.rsqrt(gvar + GN_EPS).repeat_interleave(per, dim=1)
    mu_c = gmean.repeat_interleave(per, dim=1)
    scale = rs_c * ca
    bias = cb - mu_c * scale
    if pre_bias is not None:
        bias = bias + pre_bias * scale
    return scale, bias


def _conv3d_pair_plain(x, w0, b0, ca, cb, w1):
    r = x.shape[1]
    y0, st0 = _conv3d_3x3_fused_plain(x, w0)
    sc, bi = gn_affine_from_stats(st0[:, 0], st0[:, 1], float(r ** 3), ca,
                                  cb, pre_bias=b0)
    return _conv3d_3x3_fused_plain(y0, w1, sc, bi, pre_swish=True)


@kernel("conv3d_pair", _conv3d_pair_plain,
        "lion_tpu_torch/csrc/conv3d_pair.cu",
        "lion_tpu/ops/pallas/conv3d_packed.py:608")
def conv3d_pair(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                ca: torch.Tensor, cb: torch.Tensor, w1: torch.Tensor):
    """conv1(swish(GN(conv0(x) + b0) folded with (ca, cb))) in bf16.

    x (B, R, R, R, C) bf16; w0, w1 (3, 3, 3, C, C) bf16; b0 (C,) f32 the
    conv0 bias; ca, cb (B, C) f32 the post-norm channel affine. Returns
    (y1 (B, R, R, R, C) bf16 without conv1's bias, st1 (B, 2, C) f32 the
    (sum, sumsq) of the rounded y1). Three launches: the brick conv0 (+ its
    stats), a fold kernel (one block per item), the brick conv1 with the
    fold and swish as its prologue."""
    check_cuda(x, w0, w1, dtype=torch.bfloat16)
    check_cuda(b0, ca, cb, device=x.device)
    b, r, c = x.shape[0], x.shape[1], x.shape[-1]
    if (x.shape[1:] != (r, r, r, c) or w0.shape != (3, 3, 3, c, c)
            or w1.shape != w0.shape or c % 8 or c > PAIR_MAX_C):
        raise ValueError(f"conv3d_pair: x {tuple(x.shape)}, w0 "
                         f"{tuple(w0.shape)}, w1 {tuple(w1.shape)} (needs "
                         f"Ci == Co, a multiple of 8, at most {PAIR_MAX_C})")
    p = conv_plan(b, r, c, c, torch.bfloat16)
    y0 = torch.empty_like(x)
    y1 = torch.empty_like(x)
    st = torch.empty((2, b, 2, c), device=x.device)
    fold = torch.empty((2, b, c), device=x.device)
    part, tickets = stats_scratch(p, c, x.device)
    launch("lion_conv3d_pair", ptr(x), ptr(w0), ptr(b0), ptr(ca), ptr(cb),
           ptr(w1), ptr(y0), ptr(st[0]), ptr(y1), ptr(st[1]), ptr(fold),
           ptr(part), ptr(tickets), b, r, c, *p.brick, p.tile, p.min_blocks, p.kc, p.taps, p.hpitch,
           p.wpitch, p.smem, stream_of(x))
    return y1, st[1]
