"""Fused PointNet++ set abstraction in bf16 (port of
pointnet_sa_fused_pallas, lion_tpu/ops/pallas/sa_fused.py:249).

Kernel here:
  K7 `sa_fused` (csrc/sa_fused.cu): an index-and-recompute walk, L + 1
  launches per SA block; no grouped (B, M, K, C) tensor exists, each pass
  recomputes the rows from the ball query's indices (`sa_plan` sizes it).

One SA block of the sampling path:

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
import functools
from typing import NamedTuple, Sequence

import torch

from ._cuda import check_cuda, kernel, launch, ptr, stream_of
from .conv3d import GN_EPS, GN_GROUPS
from .points import _ball_query_plain, _r2

MAX_K = 128
MAX_WIDTH = 256
MAX_LAYERS = 32       # csrc/sa_fused.cu kMaxLayers
THREADS = 256         # a block of the kernel: 8 warps
SMEM_DYN = 232448 - 1024   # the H100's 227 KB less 1 KB of static memory
SMEM_SM, SMS = 233472, 132  # an H100 SM's shared memory, its SMs
# blocks an SM of the ball query's pass and of the others (csrc/sa_fused.cu
# kBlocksSm, their __launch_bounds__)
BLOCKS_SM_QUERY, BLOCKS_SM = 4, 2
LDW = 72              # a 64-column weight stage's pitch (bf16)
RED = 2560            # floats of the statistics' reduction
ROW_BUDGET = 40 * 1024     # a tile's two bf16 row buffers
RESIDENT = 24576      # weight bytes a block keeps for a whole pass


class SaPlan(NamedTuple):
    tm: int           # centers per tile
    rows: int         # slot rows per tile, tm * K
    tiles: int        # tiles per item, M / tm
    blocks: int       # blocks per item (G) of passes 2..L+1; a block walks
                      # tiles g, g + G, ...
    blocks_query: int  # blocks per item of pass 1 (the staged cloud)
    ld: int           # row-buffer pitch in bf16 elements
    resident: bool    # every dense layer's weights stay in shared memory
    staged: bool      # pass 1 holds the item's cloud in shared memory
    smem_query: int   # pass 1's dynamic shared memory, bytes
    smem_pass: int    # the later passes'


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


@functools.lru_cache(maxsize=64)
def sa_plan(b: int, n: int, m: int, k: int,
            widths: Sequence[int]) -> SaPlan:
    """The walk's plan (csrc/sa_fused.cu sa_smem computes the same bytes and
    refuses a plan that differs): tiles of 128 slot rows, or 64 where two
    buffers of 128 wide rows would pass ROW_BUDGET (at least K rows),
    centers halved until they divide M; the dense layers' weights in
    64-column stages of PAD16(C_in) x LDW, all resident when they fit in
    RESIDENT bytes; G blocks per item (at most the tiles), so that one wave
    of as many blocks as the SMs hold fills the card."""
    ld = _pad16(max(widths)) + 8
    tm = max(128 if 2 * 128 * ld * 2 <= ROW_BUDGET else 64, k) // k
    while m % tm:
        tm //= 2
    rows = tm * k
    tiles = m // tm
    stages = [_pad16(ci) * LDW * 2 * -(-co // 64)
              for ci, co in zip(widths[:-1], widths[1:])]
    resident = sum(stages) <= RESIDENT
    wt = sum(stages) if resident else max(
        (_pad16(c) for c in widths[:-1]), default=0) * LDW * 2
    buf = rows * ld * 2
    head = buf + RED * 4 + 3 * sum(widths) * 4
    staged = head + 12 * n <= SMEM_DYN
    smem_query = head + (12 * n if staged else 0)
    smem_pass = head + (buf + wt if len(widths) > 1 else 0)

    def wave(smem, bound):   # blocks per item that one wave holds
        per_sm = max(1, min(bound, SMEM_SM // (smem + 1024)))
        return max(1, min(tiles, SMS * per_sm // max(b, 1)))

    return SaPlan(tm, rows, tiles, wave(smem_pass, BLOCKS_SM),
                  wave(smem_query, BLOCKS_SM_QUERY), ld, resident, staged,
                  smem_query, smem_pass)


def supports_sa_fused(m: int, k: int, widths: Sequence[int]) -> bool:
    """Shapes the kernel takes: K a power of two in [8, 128], M a multiple
    of 8, at most 32 layers, every width a multiple of 8 and at most
    256."""
    return (k & (k - 1) == 0 and 8 <= k <= MAX_K and m % 8 == 0
            and 0 < len(widths) <= MAX_LAYERS
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
    of layers 1..L -> (B, M, C_L) bf16. L + 1 launches of the walk
    (csrc/sa_fused.cu), no PyTorch op between them; the per-layer operands
    go to the C entry as host arrays of pointers."""
    check_cuda(points, centers, a, bc)
    b, n, _ = points.shape
    m = centers.shape[1]
    widths = [ca.shape[-1] for ca in cas]
    if (len(ws) != len(widths) - 1 or len(bs) != len(ws)
            or len(cbs) != len(cas)
            or a.shape != (b, n, widths[0]) or bc.shape != (b, m, widths[0])
            or not supports_sa_fused(m, k, widths)):
        raise ValueError(f"sa_fused: M={m}, K={k}, widths {widths}")
    dev = points.device
    for i, wt in enumerate(ws):
        check_cuda(wt, dtype=torch.bfloat16, device=dev)
        if wt.shape != (widths[i], widths[i + 1]):
            raise ValueError(f"sa_fused: layer {i + 2} kernel {wt.shape}")
        if bs[i].shape != (widths[i + 1],):
            raise ValueError(f"sa_fused: layer {i + 2} bias {bs[i].shape}")
    check_cuda(*bs, *cas, *cbs, device=dev)
    for ca, cb in zip(cas, cbs):
        if ca.shape != (b, ca.shape[-1]) or cb.shape != ca.shape:
            raise ValueError(f"sa_fused: affines {ca.shape}, {cb.shape}")
    plan = sa_plan(b, n, m, k, tuple(widths))
    # one scratch: per-block partials (f64), sc / sh, the slot indices and
    # the tickets
    part = b * max(plan.blocks, plan.blocks_query) * 2 * max(widths) * 8
    scsh = 2 * b * sum(widths) * 4
    idx = b * m * k * 4
    scratch = torch.empty(part + scsh + idx + b * 4, dtype=torch.uint8,
                          device=dev)
    base = scratch.data_ptr()
    out = torch.empty((b, m, widths[-1]), dtype=torch.bfloat16, device=dev)
    nl = len(widths)
    launch("lion_sa_fused", ptr(points), ptr(centers), ptr(a), ptr(bc),
           (ctypes.c_void_p * max(nl - 1, 1))(*map(ptr, ws)),
           (ctypes.c_void_p * max(nl - 1, 1))(*map(ptr, bs)),
           (ctypes.c_void_p * nl)(*map(ptr, cas)),
           (ctypes.c_void_p * nl)(*map(ptr, cbs)),
           (ctypes.c_int * nl)(*widths), nl, base + part + scsh, base,
           base + part, base + part + scsh + idx, ptr(out), b, n, m, k,
           plan.tm, plan.blocks, plan.blocks_query, plan.smem_query,
           plan.smem_pass,
           _r2(radius), stream_of(points))
    return out
