"""Generation metrics: MMD / COV / 1-NNA under CD and EMD, and JSD (port of
lion_tpu/eval/metrics.py).

The pairwise matrices are computed block by block on the device; the
statistics on them are numpy, as in the JAX package. Conventions kept
(reference utils/evaluation_metrics_fast.py):
  - CD entry = mean_i min_j d2 + mean_j min_i d2 (squared L2);
  - EMD entry = approximate-EMD cost / N, by K12 (`ops.emd_cost`) on the
    block's list of (sample, ref) pairs, with no repeated copies of the
    clouds;
  - lgan_mmd_cov on the (N_sample, N_ref) matrix; M_rs has ref rows, so it
    is transposed first;
  - 1-NNA: leave-one-out 1-NN accuracy on [refs; samples];
  - JSD over a 28^3 occupancy grid clipped to the unit sphere, the nearest
    cell found by an argmin on the device.

Every function takes `device` ("cuda" unless the caller names another;
without CUDA that default raises).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models.lion import resolve_device
from ..ops.chamfer import chamfer_dist, sqdist_unclamped
from ..ops.emd import emd_cost
from ..ops.interpolate import pairwise_sqdist

# EMD blocks of 16 x 33 = 528 pairs: two CTAs fit on an SM (96 KB of shared
# memory each at 2048 + 2048 points), so one launch is two full waves over
# the H100's 132 SMs
EMD_BLOCK = (16, 33)
CD_BLOCK = (8, 32)
# clouds per step of the JSD's nearest-cell search
_JSD_CHUNK = 8


def _device_cloud(pcs, device) -> torch.Tensor:
    if isinstance(pcs, torch.Tensor):
        return pcs.detach().to(device=device,
                                dtype=torch.float32).contiguous()
    return torch.from_numpy(np.asarray(pcs, np.float32)).to(device)


# ---------------------------------------------------------------- pairwise
def _cd_block(sample, ref, i, j, block_s, block_r):
    """The (block_s, block_r) chamfer values of samples i.. against refs
    j..; one sample against the whole ref block at a time."""
    ref_block = ref[j:j + block_r]
    rows = []
    for s in sample[i:i + block_s]:
        d2 = sqdist_unclamped(s[None], ref_block)            # (R, N, M)
        rows.append(d2.amin(dim=2).clamp_min_(0.0).mean(dim=1)
                    + d2.amin(dim=1).clamp_min_(0.0).mean(dim=1))
    return torch.stack(rows)


def block_pairs(i, j, block_s, block_r, device) -> torch.Tensor:
    """The (block_s * block_r, 2) int32 (sample, ref) index pairs of the
    block of samples i.. and refs j.., row by row."""
    rows = torch.arange(i, i + block_s, dtype=torch.int32, device=device)
    cols = torch.arange(j, j + block_r, dtype=torch.int32, device=device)
    return torch.stack([rows.repeat_interleave(block_r),
                        cols.repeat(block_s)], 1)


def _emd_block(sample, ref, i, j, block_s, block_r):
    """The (block_s, block_r) approximate-EMD values of samples i.. against
    refs j..: one K12 launch on the block's pair list, made on the
    device."""
    pairs = block_pairs(i, j, block_s, block_r, sample.device)
    return emd_cost(sample, ref, pairs).reshape(block_s, block_r)


def pairwise_cd(sample_pcs, ref_pcs, block_s: int = CD_BLOCK[0],
                block_r: int = CD_BLOCK[1], device="cuda") -> np.ndarray:
    """(N_s, N, 3), (N_r, M, 3) -> (N_s, N_r) numpy CD matrix."""
    return _pairwise(_cd_block, sample_pcs, ref_pcs, block_s, block_r,
                     device)


def pairwise_emd(sample_pcs, ref_pcs, block_s: int = EMD_BLOCK[0],
                 block_r: int = EMD_BLOCK[1], device="cuda") -> np.ndarray:
    """(N_s, N, 3), (N_r, M, 3) -> (N_s, N_r) numpy approximate-EMD
    matrix."""
    return _pairwise(_emd_block, sample_pcs, ref_pcs, block_s, block_r,
                     device)


def _pairwise(block_fn, sample_pcs, ref_pcs, block_s, block_r, device):
    dev = resolve_device(device)
    sample = _device_cloud(sample_pcs, dev)
    ref = _device_cloud(ref_pcs, dev)
    ns, nr = sample.shape[0], ref.shape[0]
    # pad to block multiples by repeating cloud 0, so every block has the
    # same shape; the padding is cropped at the end
    ps, pr = (-ns) % block_s, (-nr) % block_r
    if ps:
        sample = torch.cat([sample, sample[:1].expand(ps, -1, -1)])
    if pr:
        ref = torch.cat([ref, ref[:1].expand(pr, -1, -1)])
    out = torch.empty((sample.shape[0], ref.shape[0]), device=dev)
    with torch.no_grad():
        for i in range(0, sample.shape[0], block_s):
            for j in range(0, ref.shape[0], block_r):
                out[i:i + block_s, j:j + block_r] = block_fn(
                    sample, ref, i, j, block_s, block_r)
    return out[:ns, :nr].cpu().numpy()


# ---------------------------------------------------------------- metrics
def lgan_mmd_cov(all_dist: np.ndarray) -> Dict[str, float]:
    """all_dist: (N_sample, N_ref)."""
    _, n_ref = all_dist.shape
    min_val_fromsmp = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_val = all_dist.min(axis=0)
    return {
        "lgan_mmd": float(min_val.mean()),
        "lgan_cov": float(len(np.unique(min_idx)) / n_ref),
        "lgan_mmd_smp": float(min_val_fromsmp.mean()),
    }


def knn_accuracy(mxx: np.ndarray, mxy: np.ndarray, myy: np.ndarray,
                 k: int = 1, sqrt: bool = False) -> Dict[str, float]:
    """Leave-one-out k-NN two-sample classifier (reference knn)."""
    n0, n1 = mxx.shape[0], myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    m = np.block([[mxx, mxy], [mxy.T, myy]])
    if sqrt:
        m = np.sqrt(np.abs(m))
    np.fill_diagonal(m, np.inf)
    idx = np.argsort(m, axis=0)[:k]  # smallest k per column
    count = label[idx].sum(axis=0)
    pred = (count >= (k / 2.0)).astype(np.float64)
    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def compute_all_metrics(sample_pcs, ref_pcs, metric1: str = "CD",
                        metric2: Optional[str] = "EMD",
                        device="cuda") -> Dict[str, float]:
    """MMD, COV and 1-NNA under each metric (reference
    compute_all_metrics). The clouds go to the device once."""
    dev = resolve_device(device)
    sample = _device_cloud(sample_pcs, dev)
    ref = _device_cloud(ref_pcs, dev)
    results: Dict[str, float] = {}
    for metric in filter(None, [metric1, metric2]):
        pair = pairwise_cd if metric == "CD" else pairwise_emd
        m_rs = pair(ref, sample, device=dev)
        res = lgan_mmd_cov(m_rs.T)
        results.update({f"{k}-{metric}": v for k, v in res.items()})
        m_rr = pair(ref, ref, device=dev)
        m_ss = pair(sample, sample, device=dev)
        one_nn = knn_accuracy(m_rr, m_rs, m_ss, k=1, sqrt=False)
        results.update({f"1-NN-{metric}-{k}": v
                        for k, v in one_nn.items() if "acc" in k})
    return results


# ---------------------------------------------------------------- paired
def emd_cd_paired(sample_pcs, ref_pcs, batch_size: int = 32,
                  reduced: bool = True, device="cuda") -> Dict:
    """Row-aligned CD and EMD, for reconstruction eval (reference EMD_CD);
    the EMD of each batch by K12 on the diagonal pairs."""
    dev = resolve_device(device)
    sample = _device_cloud(sample_pcs, dev)
    ref = _device_cloud(ref_pcs, dev)
    cds, emds = [], []
    with torch.no_grad():
        for i in range(0, sample.shape[0], batch_size):
            dl, dr = chamfer_dist(sample[i:i + batch_size],
                                  ref[i:i + batch_size])
            cds.append(dl.mean(1) + dr.mean(1))
            diag = torch.arange(i, i + dl.shape[0], dtype=torch.int32,
                                device=dev)
            emds.append(emd_cost(sample, ref, torch.stack([diag, diag], 1)))
    cd = torch.cat(cds).cpu().numpy()
    emd = torch.cat(emds).cpu().numpy()
    if reduced:
        return {"MMD-CD": float(cd.mean()), "MMD-EMD": float(emd.mean())}
    return {"MMD-CD": cd, "MMD-EMD": emd}


# ---------------------------------------------------------------- JSD
def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False):
    """Grid cell centers in the unit cube."""
    spacing = 1.0 / float(resolution - 1)
    ax = np.arange(resolution) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    grid = grid.astype(np.float32)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


def _entropy(p, base=None):
    p = np.asarray(p, np.float64)
    p = p / p.sum()
    nz = p > 0
    h = -(p[nz] * np.log(p[nz])).sum()
    if base is not None:
        h /= np.log(base)
    return h


def _nearest_cells(pclouds, grid_flat, device) -> np.ndarray:
    """(P, N, 3) clouds -> (P, N) index of each point's nearest grid cell:
    an argmin over matmul-form distances on the device."""
    dev = resolve_device(device)
    pcs = _device_cloud(pclouds, dev)
    grid = torch.from_numpy(grid_flat).to(dev)[None]
    out = []
    with torch.no_grad():
        for i in range(0, pcs.shape[0], _JSD_CHUNK):
            chunk = pcs[i:i + _JSD_CHUNK]
            d2 = pairwise_sqdist(chunk, grid.expand(chunk.shape[0], -1, -1))
            out.append(d2.argmin(dim=-1))
    return torch.cat(out).cpu().numpy()


def entropy_of_occupancy_grid(pclouds, grid_resolution: int,
                              in_sphere: bool = False, device="cuda"):
    """Occupancy statistics. On the full grid the nearest cell of a point
    is its rounded cell; on the clipped-sphere grid an argmin on the
    device finds it among the remaining cells."""
    grid, spacing = unit_cube_grid_point_cloud(grid_resolution, in_sphere)
    grid_flat = grid.reshape(-1, 3)
    n_cells = len(grid_flat)
    grid_counters = np.zeros(n_cells)
    grid_bernoulli = np.zeros(n_cells)

    r = grid_resolution
    if n_cells < r ** 3:
        nearest = _nearest_cells(pclouds, grid_flat, device)
    else:
        pcs = np.asarray(pclouds)
        cell = np.clip(np.round((pcs + 0.5) / spacing), 0, r - 1)
        cell = cell.astype(np.int64)
        nearest = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
    for indices in nearest:
        np.add.at(grid_counters, indices, 1)
        grid_bernoulli[np.unique(indices)] += 1

    n = float(len(pclouds))
    acc_entropy = 0.0
    for g in grid_bernoulli[grid_bernoulli > 0]:
        p = g / n
        acc_entropy += _entropy([p, 1.0 - p])
    return acc_entropy / n_cells, grid_counters


def jensen_shannon_divergence(p: np.ndarray, q: np.ndarray) -> float:
    if np.any(p < 0) or np.any(q < 0):
        raise ValueError("Negative values.")
    p = p / p.sum()
    q = q / q.sum()
    e1, e2 = _entropy(p, 2), _entropy(q, 2)
    e_sum = _entropy((p + q) / 2.0, 2)
    return float(e_sum - (e1 + e2) / 2.0)


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28,
                                 device="cuda") -> float:
    """JSD over 28^3 occupancy grids. The reference passes
    in_unit_sphere=True, which its grid function reads as `clip_sphere`; the
    JAX package and this port keep that."""
    sample_var = entropy_of_occupancy_grid(sample_pcs, resolution, True,
                                           device)[1]
    ref_var = entropy_of_occupancy_grid(ref_pcs, resolution, True,
                                        device)[1]
    return jensen_shannon_divergence(sample_var, ref_var)
