"""A walk of DiT-3D's attention kernels (`csrc/attention.cu`) in numpy on
the CPU: the same shared-memory buffers, strides and offsets, the same
loads (row-major and transposed), each lane's rows and columns in
`tile_mma`, the row reductions over a row's 8 lanes, P and dS through
shared memory, and the stores, for one (item, head) at the card's tile of
64 rows and head dim 72. The forward (o, logsumexp) and the backward (dq,
dk, dv) it walks equal the plain versions (`ops.attention`) to float64
rounding, so the kernels' index arithmetic covers every output once with
the right operands. Constants mirror the source's."""
import math

import numpy as np
import pytest
import torch

from lion_tpu_torch.ops.attention import (_plain_attention_backward,
                                          _plain_attention_forward)

ROWS, THREADS, S64 = 64, 128, 68          # kRows, kThreads, kS64
D = 72
SD, NV4, REM = D + 4, D // 32, (D % 32) // 8
NJ = 4 * NV4 + REM
LANE = np.arange(THREADS)
ROW0 = 16 * (LANE // 32) + (LANE % 32) // 8      # 16 warp + lane / 8
C = LANE % 8


def col_of(j, c):
    return 32 * (j // 4) + 4 * c + j % 4 if j < 4 * NV4 \
        else 32 * NV4 + 8 * (j - 4 * NV4) + c


ROWS_I = ROW0[:, None] + 4 * np.arange(4)[None]               # (128, 4)
COLS_D = np.array([[col_of(j, c) for j in range(NJ)] for c in C])
COLS_64 = np.array([[32 * (j // 4) + 4 * c + j % 4 for j in range(8)]
                    for c in C])


def load_tile(smem, off, src, trans):
    """load_tile<D, Trans>: src (64, D) into smem at off."""
    c4n = D // 4
    for idx in range(ROWS * c4n):
        row = idx % ROWS if trans else idx // c4n
        c4 = idx // ROWS if trans else idx % c4n
        for e in range(4):
            at = (4 * c4 + e) * S64 + row if trans else row * SD + 4 * c4 + e
            smem[off + at] = src[row, 4 * c4 + e]


def tile_mma(acc, smem, a_off, ars, aks, b_off, brs, k_len, cols):
    """acc (128, 4, J) += A[row * ars + k * aks] B[k * brs + col]."""
    k = np.arange(k_len)
    a = smem[a_off + ROWS_I[:, :, None] * ars + k[None, None] * aks]
    b = smem[b_off + k[None, :, None] * brs + cols[:, None, :]]
    acc += np.einsum("tik,tkj->tij", a, b)


def row_reduce(vals, op):
    """Each row's value over its 8 lanes (xor shuffles 1, 2, 4)."""
    out = vals.copy()
    for x in (1, 2, 4):
        out = op(out, out[LANE ^ x])
    return out


def store_tile(dst, acc, mul=1.0):
    for t in range(THREADS):
        for i in range(4):
            dst[ROWS_I[t, i], COLS_D[t]] = acc[t, i] * mul


def fwd(q, k, v, scale):
    lk = k.shape[0]
    smem = np.full(2 * ROWS * SD + D * S64 + ROWS * S64, np.nan)
    qs, vs, kt = 0, ROWS * SD, 2 * ROWS * SD
    ps = kt + D * S64
    load_tile(smem, qs, q, False)
    m = np.full((THREADS, 4), -np.inf)
    l_ = np.zeros((THREADS, 4))
    acc = np.zeros((THREADS, 4, NJ))
    for k0 in range(0, lk, ROWS):
        load_tile(smem, kt, k[k0:k0 + ROWS], True)
        load_tile(smem, vs, v[k0:k0 + ROWS], False)
        s = np.zeros((THREADS, 4, 8))
        tile_mma(s, smem, qs, SD, 1, kt, S64, D, COLS_64)
        s *= scale * math.log2(math.e)
        mx = row_reduce(s.max(axis=2), np.maximum)
        m_new = np.maximum(m, mx)
        alpha = np.exp2(m - m_new)
        s = np.exp2(s - m_new[:, :, None])
        l_ = l_ * alpha + row_reduce(s.sum(axis=2), np.add)
        m = m_new
        acc *= alpha[:, :, None]
        for t in range(THREADS):
            for i in range(4):
                smem[ps + ROWS_I[t, i] * S64 + COLS_64[t]] = s[t, i]
        tile_mma(acc, smem, ps, S64, 1, vs, SD, ROWS, COLS_D)
    o = np.full((ROWS, D), np.nan)
    store_tile(o, acc / l_[:, :, None])
    lse = np.full(ROWS, np.nan)
    for t in np.nonzero(C == 0)[0]:
        lse[ROWS_I[t]] = (m[t] + np.log2(l_[t])) * math.log(2)
    return o, lse


def dkdv(q, k, v, g, lse, delta, scale):
    length = q.shape[0]
    smem = np.full(2 * ROWS * SD + 2 * D * S64 + 2 * ROWS * S64 + 2 * ROWS,
                   np.nan)
    qs, gs = 0, ROWS * SD
    kt = 2 * ROWS * SD
    vt = kt + D * S64
    ps = vt + D * S64
    dss = ps + ROWS * S64
    load_tile(smem, kt, k, True)
    load_tile(smem, vt, v, True)
    acc_k = np.zeros((THREADS, 4, NJ))
    acc_v = np.zeros((THREADS, 4, NJ))
    for q0 in range(0, length, ROWS):
        load_tile(smem, qs, q[q0:q0 + ROWS], False)
        load_tile(smem, gs, g[q0:q0 + ROWS], False)
        lr = lse[q0:q0 + ROWS] * math.log2(math.e)
        dr = delta[q0:q0 + ROWS]
        s = np.zeros((THREADS, 4, 8))
        dp = np.zeros((THREADS, 4, 8))
        tile_mma(s, smem, qs, SD, 1, kt, S64, D, COLS_64)
        tile_mma(dp, smem, gs, SD, 1, vt, S64, D, COLS_64)
        p = np.exp2(s * scale * math.log2(math.e) - lr[ROWS_I][:, :, None])
        ds = p * (dp - dr[ROWS_I][:, :, None])
        for t in range(THREADS):
            for i in range(4):
                smem[ps + ROWS_I[t, i] * S64 + COLS_64[t]] = p[t, i]
                smem[dss + ROWS_I[t, i] * S64 + COLS_64[t]] = ds[t, i]
        tile_mma(acc_v, smem, ps, 1, S64, gs, SD, ROWS, COLS_D)
        tile_mma(acc_k, smem, dss, 1, S64, qs, SD, ROWS, COLS_D)
    dk, dv = np.full((ROWS, D), np.nan), np.full((ROWS, D), np.nan)
    store_tile(dk, acc_k, scale)
    store_tile(dv, acc_v)
    return dk, dv


def dq_walk(q, k, v, g, lse, delta, scale):
    lk = k.shape[0]
    smem = np.full(3 * ROWS * SD + 2 * D * S64 + ROWS * S64, np.nan)
    qs, gs, ks = 0, ROWS * SD, 2 * ROWS * SD
    kt = 3 * ROWS * SD
    vt = kt + D * S64
    dss = vt + D * S64
    load_tile(smem, qs, q, False)
    load_tile(smem, gs, g, False)
    lr = (lse * math.log2(math.e))[ROWS_I]
    dr = delta[ROWS_I]
    acc = np.zeros((THREADS, 4, NJ))
    for k0 in range(0, lk, ROWS):
        load_tile(smem, ks, k[k0:k0 + ROWS], False)
        load_tile(smem, kt, k[k0:k0 + ROWS], True)
        load_tile(smem, vt, v[k0:k0 + ROWS], True)
        s = np.zeros((THREADS, 4, 8))
        dp = np.zeros((THREADS, 4, 8))
        tile_mma(s, smem, qs, SD, 1, kt, S64, D, COLS_64)
        tile_mma(dp, smem, gs, SD, 1, vt, S64, D, COLS_64)
        ds = np.exp2(s * scale * math.log2(math.e) - lr[:, :, None]) \
            * (dp - dr[:, :, None])
        for t in range(THREADS):
            for i in range(4):
                smem[dss + ROWS_I[t, i] * S64 + COLS_64[t]] = ds[t, i]
        tile_mma(acc, smem, dss, S64, 1, ks, SD, ROWS, COLS_D)
    out = np.full((ROWS, D), np.nan)
    store_tile(out, acc, scale)
    return out


def test_lane_tiles_cover_each_output_once():
    rows = sorted((int(r), int(c)) for t in range(THREADS)
                  for r in ROWS_I[t] for c in COLS_D[t])
    assert rows == [(r, c) for r in range(ROWS) for c in range(D)]
    keys = sorted((int(r), int(c)) for t in range(THREADS)
                  for r in ROWS_I[t] for c in COLS_64[t])
    assert keys == [(r, c) for r in range(ROWS) for c in range(ROWS)]
    # float4 rows and shared buffers start on 16 bytes
    assert SD % 4 == 0 and S64 % 4 == 0 and (ROWS * SD) % 4 == 0 \
        and (D * S64) % 4 == 0
    # A's scalar reads of a step hit 4 distinct banks (rows r = 0..3 of a
    # warp), in either layout
    for stride in (SD, S64):
        assert len({(r * stride) % 32 for r in range(4)}) == 4


@pytest.mark.parametrize("lk", [64, 128])
def test_walk_equals_the_plain_versions(lk):
    g = torch.Generator().manual_seed(lk)
    q = torch.randn(1, 1, ROWS, D, generator=g, dtype=torch.float64)
    k, v = (torch.randn(1, 1, lk, D, generator=g, dtype=torch.float64)
            for _ in range(2))
    do = torch.randn(1, 1, ROWS, D, generator=g, dtype=torch.float64)
    scale = 1.0 / math.sqrt(D)
    o, lse = _plain_attention_forward(q, k, v, scale)
    dq, dk, dv = _plain_attention_backward(q, k, v, o, lse, do, scale)
    n = lambda t: t[0, 0].numpy()  # noqa: E731
    wo, wl = fwd(n(q), n(k), n(v), scale)
    # float64 sums in another order
    np.testing.assert_allclose(wo, n(o), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(wl, lse[0].numpy(), rtol=1e-12, atol=1e-12)
    delta = (n(do) * n(o)).sum(axis=1)
    wdk, wdv = zip(*[dkdv(n(q), n(k)[k0:k0 + ROWS], n(v)[k0:k0 + ROWS],
                          n(do), wl, delta, scale)
                     for k0 in range(0, lk, ROWS)])
    np.testing.assert_allclose(np.concatenate(wdk), n(dk), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np.concatenate(wdv), n(dv), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(dq_walk(n(q), n(k), n(v), n(do), wl, delta,
                                       scale), n(dq), rtol=1e-10, atol=1e-12)
