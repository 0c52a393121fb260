"""Approximate Earth Mover's Distance (port of lion_tpu/ops/emd.py and
lion_tpu/ops/pallas/emd.py).

The auction of PyTorchEMD's `approxmatch`: ten levels of soft matching with
kernel exp(level * d2), level = -(4^j) for j = 7..-1 and then 0, scaling
the row and column capacities in turn; the cost is sum(match * d2) over
squared distances, divided by N.

  `approx_match(d2, n, m)`: the dense match (B, N, M), plain PyTorch.
  `emd_approx(sample, ref)`: differentiable cost (B,); the match is
     detached, so the gradient flows through d2 only (the reference's
     `matchcost_backward`). The VAE losses use it.

Kernel here:
  K12 `emd_cost` (csrc/emd.cu): the cost alone, no gradient, for a list
     of (sample, ref) pairs, as the evaluation metrics need it. Its plain
     version is `approx_match` on each pair, taken a few pairs at a time.
"""
from __future__ import annotations

import torch

from ._cuda import check_cuda, kernel, launch, no_tf32, ptr, stream_of
from .interpolate import pairwise_sqdist

# the auction's levels: -(4^j) for j = 7..-1, then 0
_LEVELS = [-float(4.0 ** j) for j in range(7, -2, -1)] + [0.0]
# a CTA's shared memory holds both clouds, 24 bytes per point, beside the
# kernel's 16 static partial sums (csrc/emd.cu)
_MAX_SMEM = 227 * 1024 - 64
# pairs per step of the plain version: bounds its (P, N, M) temporaries
_PLAIN_CHUNK = 8


def _multipliers(n: int, m: int):
    """The capacities of each row and column: integer ratios when N != M."""
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def approx_match(d2: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """d2 (B, N, M) squared distances -> match (B, N, M).

    Two (B, N, M) buffers: k = exp(level * d2) is made in place and scaled
    in place into the level's w. The two contractions are batched
    mat-vec products in full fp32 (`no_tf32`)."""
    b = d2.shape[0]
    multi_l, multi_r = _multipliers(n, m)
    remain_l = torch.full((b, n), multi_l, device=d2.device)
    remain_r = torch.full((b, m), multi_r, device=d2.device)
    match = torch.zeros_like(d2)
    k = torch.empty_like(d2)
    with no_tf32():
        for level in _LEVELS:
            torch.mul(d2, level, out=k).exp_()
            suml = 1e-9 + torch.bmm(k, remain_r[:, :, None])[..., 0]
            ratio_l = remain_l / suml
            sumr = torch.bmm(ratio_l[:, None, :], k)[:, 0] * remain_r
            ratio_r = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0) \
                * remain_r
            remain_r = torch.clamp_min(remain_r - sumr, 0.0)
            w = k.mul_(ratio_l[:, :, None]).mul_(ratio_r[:, None, :])
            match.add_(w)
            remain_l = torch.clamp_min(remain_l - w.sum(dim=2), 0.0)
    return match


def emd_approx(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """sample (B, N, 3), ref (B, M, 3) -> per-item cost (B,), divided by N,
    differentiable through the distances."""
    sample, ref = sample.float(), ref.float()
    n, m = sample.shape[1], ref.shape[1]
    d2 = pairwise_sqdist(sample, ref)
    match = approx_match(d2.detach(), n, m)
    return (match * d2).sum(dim=(1, 2)) / float(n)


def _emd_cost_plain(sample, ref, pairs):
    costs = []
    for i in range(0, pairs.shape[0], _PLAIN_CHUNK):
        idx = pairs[i:i + _PLAIN_CHUNK].long()
        costs.append(emd_approx(sample[idx[:, 0]], ref[idx[:, 1]]))
    return torch.cat(costs)


@kernel("emd_cost", _emd_cost_plain, "lion_tpu_torch/csrc/emd.cu",
        "lion_tpu/ops/pallas/emd.py:85")
def emd_cost(sample: torch.Tensor, ref: torch.Tensor,
             pairs: torch.Tensor) -> torch.Tensor:
    """sample (S, N, 3), ref (R, M, 3) f32, pairs (P, 2) int32 of (sample,
    ref) indices -> (P,) approximate-EMD costs divided by N (NaN for a pair
    whose indices are out of range). No gradient."""
    check_cuda(sample, ref)
    check_cuda(pairs, dtype=torch.int32, device=sample.device)
    s, n, _ = sample.shape
    r, m, _ = ref.shape
    p = pairs.shape[0]
    if p < 1 or n < 1 or m < 1 or 24 * (n + m) > _MAX_SMEM:
        raise ValueError(f"emd_cost: unsupported P={p}, N={n}, M={m} (the "
                         f"two clouds must fit 24 * (N + M) <= {_MAX_SMEM} "
                         f"bytes of shared memory)")
    out = torch.empty((p,), device=sample.device)
    launch("lion_emd_cost", ptr(sample), ptr(ref), ptr(pairs), ptr(out), p,
           s, r, n, m, stream_of(sample))
    return out
