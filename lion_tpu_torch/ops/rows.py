"""The ordered row sum and the row gather, each the other's gradient.

Kernel here:
  `row_sum` (csrc/row_sum.cu): out[b, idx[b, r]] += rows[b, r] in float32,
     each output row the sum of its rows in ascending r. It replaces no TPU
     kernel: it is the transpose of the training backwards' row gathers
     (K2 and K13, K5, K6, and K3's under a second derivative), which the
     JAX package leaves to XLA's scatter-add. A float scatter-add with
     atomics reorders its sums from call to call; this one is written
     once per output element in a fixed order, so a backward repeats bit
     for bit, and equals the plain version (a float32 `scatter_add_`,
     which adds in ascending r on the CPU) bit for bit.

`scatter_rows` and `gather_rows` are autograd Functions around the row
sum and `torch.gather`: the gradient of each is the other, so a backward
taken with create_graph (the Jacobian regularizer) stays in fixed order
through its second derivative too.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, check_float, kernel, launch, ptr, stream_of

SMEM_MAX = 232448   # a block's shared memory on the H100
ORDER_THREADS = 1024  # csrc/stable_order.cuh kOrderThreads


def order_words(n: int, nkeys: int) -> int:
    """The stable order's counts (one pad word after every 32 buckets, and
    one at the end) and the n keys, in int32 words
    (csrc/stable_order.cuh: order_words)."""
    return nkeys + (nkeys >> 5) + 1 + n


def order_smem(n: int, nkeys: int) -> int:
    """Shared memory of the stable order of n keys into nkeys buckets, or 0
    when its words do not fit and live in a global scratch
    (csrc/stable_order.cuh: order_smem)."""
    need = order_words(n, nkeys) * 4
    return need if need + 4 * (ORDER_THREADS // 32) <= SMEM_MAX else 0


def _row_sum_plain(idx: torch.Tensor, rows: torch.Tensor,
                   n: int) -> torch.Tensor:
    """idx (B, R) integer, rows (B, R, C) -> (B, n, C) float32."""
    b, _, c = rows.shape
    out = torch.zeros((b, n, c), device=rows.device)
    return out.scatter_add_(1, idx.long()[:, :, None].expand(-1, -1, c),
                            rows.float())


@kernel("row_sum", _row_sum_plain, "lion_tpu_torch/csrc/row_sum.cu",
        "none (XLA's scatter-add: lion_tpu/ops/points.py:241)")
def row_sum(idx: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    """idx (B, R) int32 in [0, n), rows (B, R, C) f32 or bf16 -> (B, n, C)
    f32 with out[b, idx[b, r]] += rows[b, r] in ascending r. Two launches:
    the inverse index (offsets (B, n + 1), order (B, R)), then each output
    element written once."""
    dt = check_float(rows, "row_sum")
    check_cuda(idx, dtype=torch.int32)
    check_cuda(rows, dtype=dt, device=idx.device)
    b, r, c = rows.shape
    if idx.shape != (b, r) or n < 1 or c < 1:
        raise ValueError(f"row_sum: idx {tuple(idx.shape)}, rows "
                         f"{tuple(rows.shape)}, n {n}")
    words = b * (n + 1 + r)
    extra = 0 if order_smem(r, n) else b * order_words(r, n)
    scratch = torch.empty(words + extra, dtype=torch.int32,
                          device=idx.device)
    base = scratch.data_ptr()
    out = torch.empty((b, n, c), device=idx.device)
    launch("lion_row_sum", ptr(idx), ptr(rows), base,
           base + 4 * b * (n + 1), base + 4 * words if extra else None,
           ptr(out), b, r, n, c, int(dt == torch.bfloat16),
           stream_of(idx))
    return out


def _as_int32(idx: torch.Tensor) -> torch.Tensor:
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, rows, n):
        ctx.save_for_backward(idx)
        ctx.dtype = rows.dtype
        return row_sum(idx, rows.contiguous(), n)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, gather_rows(g, idx).to(ctx.dtype), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[1], x.dtype
        c = x.shape[-1]
        return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, c))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, g, ctx.n).to(ctx.dtype), None


def scatter_rows(idx: torch.Tensor, rows: torch.Tensor,
                 n: int) -> torch.Tensor:
    """idx (B, R) integer in [0, n), rows (B, R, C) f32 or bf16 ->
    (B, n, C) float32, out[b, idx[b, r]] += rows[b, r] summed in ascending
    r; differentiable (its gradient is `gather_rows`)."""
    return _ScatterRows.apply(_as_int32(idx.contiguous()), rows, n)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, R) integer in [0, N) -> (B, R, C) with
    out[b, r] = x[b, idx[b, r]]; its gradient sums in fixed order
    (`scatter_rows`)."""
    return _GatherRows.apply(x, _as_int32(idx.contiguous()))
