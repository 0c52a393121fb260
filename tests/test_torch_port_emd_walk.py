"""The approximate-EMD kernel (K12, csrc/emd.cu) walked in float32 PyTorch
on the CPU, against its plain version and the JAX package.

The kernel runs only on the card (tests/test_torch_port_gpu.py); this file
holds its schedule: the first row walk (level 0's row sums of k @
remain_r), per level a column walk (k^T @ ratio_l, then ratio_r and
remain_r), the fused row walks that end level L and start level L+1 from
one exp (k_L = (k_{L+1}^2)^2, since t_L = 4 t_{L+1} exactly), level 8's
last row walk, and level 0 (k = 1) as two block sums and a walk of its
cost alone: 19 exps an entry. Every sum runs in the kernel's order: each
row's (column's) sum over the other cloud in index order, the block sums
and the cost by thread, then lanes, then warps. Its arithmetic too: the
clouds scaled by sqrt(log2 e), each walk's point prescaled by its level's
power of two so that t = level * D in four fused multiply-adds (rounded
once: a float64 product and sum rounded to float32), no clamp of D at 0;
the kernel's `ex2.approx` is `torch.exp2` here. The walk is held to
`_emd_cost_plain`, `lion_tpu.ops.emd.emd_approx` and the TPU kernel in
interpret mode at the JAX package's gate (rtol 2e-3, atol 1e-5).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.ops import emd as jemd
from lion_tpu.ops.pallas.emd import emd_approx_pallas

from lion_tpu_torch.ops.emd import _emd_cost_plain, _multipliers

from test_torch_port_sample import one_torch_thread  # noqa: F401

SOURCE = (Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
          / "emd.cu").read_text()
F32 = torch.float32
EMD_RTOL, EMD_ATOL = 2e-3, 1e-5
# csrc/emd.cu: the block, the rows a thread owns, the levels; the clouds
# are stored scaled by sqrt(log2 e) and a walk's t = -(4^(7 - lv)) * D
THREADS, ROWS, LEVELS = 512, 4, 10
SQRT_LOG2E = np.float32(1.20112240878644983)
LN2 = np.float32(0.693147180559945309)


def _level_scale(lv):
    return np.float32(np.ldexp(1.0, 14 - 2 * lv))


def test_level_constants_are_the_sources():
    for text in ("constexpr int kThreads = 512;", "constexpr int kRows = 4;",
                 "constexpr int kLevels = 10;",
                 "constexpr float kSqrtLog2e = 1.20112240878644983f;",
                 "constexpr float kLn2 = 0.693147180559945309f;",
                 "ldexpf(1.0f, 14 - 2 * lv)"):
        assert text in SOURCE, text
    levels = [-float(4.0 ** j) for j in range(7, -2, -1)]
    assert [-_level_scale(lv) for lv in range(LEVELS - 1)] == levels
    assert SQRT_LOG2E == np.float32(np.sqrt(np.log2(np.e)))
    assert LN2 == np.float32(np.log(2.0))


def test_t_of_a_level_is_four_times_the_next_bit_for_bit():
    """A walk's t = s * D from its point prescaled by s = -level_scale, for
    the source's levels: t_L == 4 t_{L+1} bit for bit, and the same value
    whichever cloud is the row, so one exp gives both levels' kernels and
    every walk weighs an entry alike."""
    rs = np.random.RandomState(0)
    for offset in (0.0, 1.5):
        x = torch.from_numpy((rs.randn(1, 300, 3) * 0.3 + offset).astype(
            np.float32))
        y = torch.from_numpy((rs.randn(1, 200, 3) * 0.3 + offset).astype(
            np.float32))
        w = _Walk(x, y)
        for lv in range(LEVELS - 2):
            t_l = w.t_matrix(w.xs, w.ys, -_level_scale(lv))
            t_next = w.t_matrix(w.xs, w.ys, -_level_scale(lv + 1))
            assert torch.equal(t_l, 4 * t_next), lv
            assert torch.equal(t_l, w.t_matrix(w.ys, w.xs,
                                               -_level_scale(lv)).mT)


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------
class _Walk:
    """K12 on a batch of pairs x (P, N, 3), y (P, M, 3), float32; counts the
    exps it takes."""

    def __init__(self, x, y):
        self.exps = 0
        self.xs, self.ys = self._points(x), self._points(y)

    @staticmethod
    def _points(c):
        """(X, Y, Z, W): the coordinates times sqrt(log2 e) and W their
        squared norm, op by op."""
        c = c * SQRT_LOG2E
        sq = (c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]) \
            + c[..., 2] * c[..., 2]
        return torch.cat([c, sq[..., None]], -1)

    @staticmethod
    def _fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    def _exp2(self, t):
        self.exps += t.numel()
        return torch.exp2(t)

    @staticmethod
    def _own(pts, s):
        """s * (-2X, -2Y, -2Z, W), as own_points forms it."""
        s = torch.tensor(s, dtype=F32)
        return torch.cat([(-2.0 * s) * pts[..., :3], s * pts[..., 3:]], -1)

    def _t(self, p, q, s):
        """scaled_dist: s * D of the own points p (prescaled) and one point
        q (P, 4) of the other cloud."""
        fma = self._fma
        s = torch.tensor(s, dtype=F32)
        return fma(p[..., 0], q[:, None, 0], fma(p[..., 1], q[:, None, 1], fma(
            p[..., 2], q[:, None, 2], fma(s, q[:, None, 3], p[..., 3]))))

    def t_matrix(self, own, other, s):
        p = self._own(own, s)
        return torch.stack([self._t(p, other[:, j], s)
                            for j in range(other.shape[1])], -1)

    def exp_sums(self, own, other, a, s):
        """Each own point's sum over `other` in index order of 2^(s D) *
        a[j]."""
        p = self._own(own, s)
        total = torch.zeros(p.shape[:2], dtype=F32)
        for j in range(other.shape[1]):
            k = self._exp2(self._t(p, other[:, j], s))
            total = self._fma(k, a[:, j, None], total)
        return total

    def row_walk(self, ratio_r, remain_r, s, fused):
        """(mass, wd, next) of each row, t = s D: k_L = (k^2)^2 when fused;
        wd sums k_L ratio_r t, then is divided by s (a power of two)."""
        fma = self._fma
        p = self._own(self.xs, s)
        mass, wd, nxt = (torch.zeros(p.shape[:2], dtype=F32)
                         for _ in range(3))
        for j in range(self.ys.shape[1]):
            t = self._t(p, self.ys[:, j], s)
            k = self._exp2(t)
            if fused:
                nxt = fma(k, remain_r[:, j, None], nxt)
                k = k * k
                k = k * k
            a = k * ratio_r[:, j, None]
            mass = mass + a
            wd = fma(a, t, wd)
        return mass, wd * torch.tensor(1.0 / s, dtype=F32), nxt

    def cost_walk(self, ratio_r):
        p = self._own(self.xs, 1.0)
        wd = torch.zeros(p.shape[:2], dtype=F32)
        for j in range(self.ys.shape[1]):
            wd = self._fma(ratio_r[:, j, None],
                           self._t(p, self.ys[:, j], 1.0), wd)
        return wd


def _block_sum(v):
    """block_sum: thread t sums v[t], v[t + 512], ... in order; lanes by
    a shuffle butterfly; then the 16 warps in order. v (P, K)."""
    rounds = -(-v.shape[1] // THREADS)
    padded = torch.zeros(v.shape[0], rounds * THREADS, dtype=F32)
    padded[:, :v.shape[1]] = v
    s = torch.zeros(v.shape[0], THREADS, dtype=F32)
    for k in range(rounds):
        s = s + padded[:, k * THREADS:(k + 1) * THREADS]
    s = s.reshape(-1, THREADS // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ off]
    total = torch.zeros(v.shape[0], dtype=F32)
    for w in range(THREADS // 32):
        total = total + s[:, w, 0]
    return total


def _final_cost(cost, n):
    """The threads' costs (P, threads) summed as the kernel's epilogue: a
    shuffle-down tree in each warp (lane 0's value), then the warps in
    order, times ln 2 (the walks summed D = log2(e) d2), over N."""
    c = cost.reshape(-1, THREADS // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        c = c + c[..., torch.where(lanes + off < 32, lanes + off, lanes)]
    total = torch.zeros(cost.shape[0], dtype=F32)
    for w in range(THREADS // 32):
        total = total + c[:, w, 0]
    return total * LN2 / np.float32(n)


def _column_update(ratio_r_remain_r, colsum):
    _, rr = ratio_r_remain_r
    sumr = colsum * rr
    return (torch.clamp_max(rr / (sumr + np.float32(1e-9)), 1.0) * rr,
            torch.clamp_min(rr - sumr, 0.0))


def emd_walk(x, y):
    """K12's schedule on pairs x (P, N, 3), y (P, M, 3) -> ((P,) costs over
    N, the exps taken)."""
    x, y = x.float(), y.float()
    p, n, m = x.shape[0], x.shape[1], y.shape[1]
    assert n <= THREADS * ROWS   # one row base: thread t owns rows r 512 + t
    multi_l, multi_r = _multipliers(n, m)
    w = _Walk(x, y)
    eps = np.float32(1e-9)
    remain_l = torch.full((p, n), multi_l, dtype=F32)
    remain_r = torch.full((p, m), multi_r, dtype=F32)
    ratio_r = torch.zeros((p, m), dtype=F32)
    cost = torch.zeros((p, THREADS * ROWS), dtype=F32)   # by row slot

    ratio_l = remain_l / (eps + w.exp_sums(w.xs, w.ys, remain_r,
                                           -_level_scale(0)))
    for lv in range(LEVELS - 1):
        colsum = w.exp_sums(w.ys, w.xs, ratio_l, -_level_scale(lv))
        ratio_r, remain_r = _column_update((ratio_r, remain_r), colsum)
        fused = lv < LEVELS - 2
        mass, wd, nxt = w.row_walk(ratio_r, remain_r,
                                   -_level_scale(lv + 1 if fused else lv),
                                   fused)
        remain_l = torch.clamp_min(remain_l - ratio_l * mass, 0.0)
        cost[:, :n] = cost[:, :n] + ratio_l * wd
        if fused:
            ratio_l = remain_l / (eps + nxt)
    # the last level, 0: k = 1
    ratio_l = remain_l / (eps + _block_sum(remain_r))[:, None]
    ratio_r, _ = _column_update((ratio_r, remain_r),
                                _block_sum(ratio_l)[:, None])
    cost[:, :n] = cost[:, :n] + ratio_l * w.cost_walk(ratio_r)
    # a thread's cost sums its rows r 512 + t in the order r = 0..3
    by_thread = torch.zeros((p, THREADS), dtype=F32)
    for r in range(ROWS):
        by_thread = by_thread + cost[:, r * THREADS:(r + 1) * THREADS]
    return _final_cost(by_thread, n), w.exps


def _clouds(seed, *shape, scale=0.3, offset=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + offset).astype(np.float32)


def _references(a, b):
    """(plain, lion_tpu's XLA form, the TPU kernel in interpret mode) of
    the pairs (a[i], b[i])."""
    pairs = torch.stack([torch.arange(a.shape[0], dtype=torch.int32)] * 2, 1)
    plain = _emd_cost_plain(torch.from_numpy(a), torch.from_numpy(b), pairs)
    xla = jemd.emd_approx(jnp.asarray(a), jnp.asarray(b))
    pallas = emd_approx_pallas(jnp.asarray(a), jnp.asarray(b),
                               interpret=True)
    return plain.numpy(), np.asarray(xla), np.asarray(pallas)


@pytest.mark.parametrize("n,m,offset", [
    (128, 128, 0.0), (128, 256, 0.0), (256, 128, 0.0),
    # clouds far from the origin: the matmul-form d2 cancels |p|^2 + |q|^2
    (128, 128, (1.5, -1.0, 0.5))])
def test_emd_walk_matches_plain_and_jax(n, m, offset):
    a = _clouds(1, 3, n, 3, offset=np.asarray(offset, np.float32))
    b = _clouds(2, 3, m, 3, scale=0.35, offset=np.asarray(offset, np.float32))
    got, exps = emd_walk(torch.from_numpy(a), torch.from_numpy(b))
    assert exps == 19 * 3 * n * m   # 19 exps an entry
    for want in _references(a, b):
        np.testing.assert_allclose(got.numpy(), want, rtol=EMD_RTOL,
                                   atol=EMD_ATOL)


def test_emd_walk_of_a_permuted_copy_is_near_zero():
    a = _clouds(3, 2, 128, 3)
    perm = np.random.RandomState(4).permutation(128)
    got, _ = emd_walk(torch.from_numpy(a), torch.from_numpy(a[:, perm]))
    assert float(got.max()) < 1e-3
    plain = _references(a, a[:, perm].copy())[0]
    np.testing.assert_allclose(got.numpy(), plain, rtol=EMD_RTOL,
                               atol=EMD_ATOL)


def test_emd_walk_block_sums_follow_the_kernels_order():
    """The emulated block sum of more than a block's worth equals the sum
    taken thread, lane butterfly, warp by hand, and the epilogue's
    shuffle-down tree equals lane 0's pairwise sums."""
    rs = np.random.RandomState(5)
    v = torch.from_numpy(rs.rand(1, 1300).astype(np.float32))
    threads = [np.float32(0)] * THREADS
    for i in range(1300):
        threads[i % THREADS] = np.float32(threads[i % THREADS]
                                          + np.float32(v[0, i]))
    warps = []
    for wi in range(THREADS // 32):
        s = np.array(threads[wi * 32:(wi + 1) * 32], np.float32)
        for off in (16, 8, 4, 2, 1):
            s = (s + s[np.arange(32) ^ off]).astype(np.float32)
        warps.append(s[0])
    want = np.float32(0)
    for x in warps:
        want = np.float32(want + x)
    assert float(_block_sum(v)[0]) == float(want)
    c = torch.from_numpy(rs.rand(1, THREADS).astype(np.float32))
    lane0 = []
    for wi in range(THREADS // 32):
        s = c[0, wi * 32:(wi + 1) * 32].numpy().copy()
        for off in (16, 8, 4, 2, 1):
            s[:off] = (s[:off] + s[off:2 * off]).astype(np.float32)
        lane0.append(s[0])
    total = np.float32(0)
    for x in lane0:
        total = np.float32(total + x)
    assert float(_final_cost(c, 1)[0]) == float(total * LN2)
    assert re.search(r"__shfl_down_sync\(0xffffffffu, cost, off\)", SOURCE)
    assert re.search(r"__shfl_xor_sync\(0xffffffffu, s, off\)", SOURCE)
