"""The 3-NN interpolation kernel (K6, csrc/three_nn.cu) and the three ball
queries, which share one scan (csrc/ball_scan.cuh): the fused ball query +
grouping kernel (K2, csrc/ball_query_group.cu), the index ball query (K11,
csrc/ball_query.cu) and the channel-first grouping (K13,
csrc/ball_query_group_cf.cu), walked in numpy on the CPU, against the plain
versions and the JAX package.

The kernels run only on the card (tests/test_torch_port_gpu.py); this file
holds their logic and plans:
  * K6: L lanes share a point, lane s scanning the centers j = s mod L of
    each shared-memory tile (padded with centers at d2 = inf) in index
    order, four a step, with a strict '<' insertion where one of the four
    beats the third best; the
    lanes' triples merge in log2 L butterfly rounds, the partner's three
    inserted under the order (d2, index), so every lane ends with the
    serial scan's three; then the weights and the block's output chunks,
    each thread stepping its (point, chunk) without a divide (16-byte
    chunks when C allows, else a warp a point). Its indices, weights and
    output equal `_three_nn_interpolate_plain`'s bit for bit and
    `lion_tpu`'s (the XLA form, and the Pallas kernel in interpret mode);
  * K2: a warp scans two centers at once over each cloud tile (padded
    with points at infinity), four 32-point chunks a round, the rounds
    without a hit skipped, the slots assigned by prefix popcounts in index
    order, the scan stopping after the round in which both centers reach
    K hits; the fill of the rows; each pair's span written flat by its
    warp (or the block, when the block holds one pair), 16 bytes or single
    floats a thread, every (row, column) stepped without a divide. Its balls
    equal `_ball_query_plain`'s (K11's plain version) and its rows
    `_ball_query_group_plain`'s bit for bit and `lion_tpu`'s;
  * K11: K2's scan, then each pair's 2 K slots written by its warp in
    16-byte chunks (single ints when K % 4 != 0), the fill in registers.
    Its balls equal `_ball_query_plain`'s and `lion_tpu`'s `ball_query`
    (the XLA form, and the Pallas kernel in interpret mode);
  * K13: a block of centers and a group of slots; K2's scan up to the
    group's last slot and the fill, then the warps' units (a slot's
    feature rows in chunks, the first with its 3 coordinate rows): 4 x 4
    tiles loaded by rows and stored by columns where 4 divides C, M and
    the block, else staged with lanes along the channels into the warp's
    transpose buffer and written with lanes along (row, center). Its
    output equals
    `_ball_query_group_cf_plain`'s bit for bit and `lion_tpu`'s XLA form,
    fp32 and bf16;
  * the plans (`three_nn_plan`, `bqg_plan`, `bq_plan`, `bqg_cf_plan`)
    cover every point, center and output element once, fill the H100 at
    the main path's levels within its shared memory, and their limits are
    the sources' constants.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu.ops import interpolate as jinterp
from lion_tpu.ops import points as jpoints
from lion_tpu.ops.pallas.ball_query import ball_query_pallas
from lion_tpu.ops.pallas.ball_query_group import ball_query_group_pallas
from lion_tpu.ops.pallas.three_nn import three_nn_interpolate_pallas

from lion_tpu_torch.ops.interpolate import (
    THREE_NN_FILL_THREADS, THREE_NN_GROUP, THREE_NN_MAX_LANES,
    THREE_NN_MAX_THREADS, THREE_NN_MIN_BLOCKS, THREE_NN_TILE,
    THREE_NN_UNROLL, _three_nn_interpolate_plain, three_nn_plan)
from lion_tpu_torch.ops.points import (
    BQG_CHUNKS, BQG_MAX_CENTERS, BQG_MAX_THREADS, BQG_MIN_BLOCKS,
    BQG_SMEM_MAX, BQG_TILE, CF_MIN_BLOCKS, CF_MIN_CENTERS, CF_ROWS,
    _ball_query_group_cf_plain, _ball_query_group_plain, _ball_query_plain,
    _r2, bq_plan, bq_smem, bqg_cf_plan, bqg_cf_smem, bqg_plan, bqg_smem)

from test_torch_port_sample import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
F32 = np.float32
SMEM_BYTES = 232448         # a block's shared memory on the H100
STATIC_SMEM = 48 * 1024     # a block's static shared memory
# (N, M) of the U-Net's FP levels, C = 128 features + the 64-d time
# embedding at each (nn/unet.py); (N, M, C, radius) of its SA levels
FP_LEVELS = [(64, 16), (256, 64), (1024, 256), (2048, 1024)]
SA_LEVELS = [(2048, 1024, 32, 0.1), (1024, 256, 64, 0.2),
             (256, 64, 128, 0.4), (64, 16, 192, 0.8)]


def _constant(source, name):
    expr = re.search(rf"constexpr int {name} = ([^;]+);",
                     (CSRC / source).read_text()).group(1)
    return int(expr.split("//")[0])


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# --------------------------------------------------------------------------
# K6
# --------------------------------------------------------------------------
def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _insert(best_d, best_i, d, i, lex):
    """The kernel's insertion into the sorted triples (N, 3), vectorized
    over the points: strict '<' on d2 in the scan, the order (d2, index)
    in the merge."""
    def before(k):
        return (d < best_d[:, k]) | (lex & (d == best_d[:, k])
                                     & (i < best_i[:, k]))
    b2, b1, b0 = before(2), before(1), before(0)
    new_d, new_i = best_d.copy(), best_i.copy()
    at2 = b2 & ~b1
    at1 = b1 & ~b0
    new_d[b1, 2], new_i[b1, 2] = best_d[b1, 1], best_i[b1, 1]
    new_d[b0, 1], new_i[b0, 1] = best_d[b0, 0], best_i[b0, 0]
    for at, k in ((at2, 2), (at1, 1), (b0, 0)):
        new_d[at, k], new_i[at, k] = d[at], i[at]
    return new_d, new_i


def _k6_scan(points, centers, lanes):
    """K6's scan: lane s takes the centers j = s mod L of each tile in
    index order, four a step, the step's least inserted first and the
    others, in index order, where one of them also beats the new third
    best. [(d (N, 3), idx (N, 3))] a lane."""
    n, m = len(points), len(centers)
    p2 = _dot3(points, points)
    out = []
    step = THREE_NN_GROUP * lanes
    for s in range(lanes):
        bd, bi = np.full((n, 3), np.inf, F32), np.zeros((n, 3), np.int64)
        for t0 in range(0, m, THREE_NN_TILE):
            cnt = min(THREE_NN_TILE, m - t0)
            # the tile padded to whole steps with centers at d2 = inf
            pad = -(-cnt // step) * step - cnt
            tile = np.concatenate([centers[t0:t0 + cnt],
                                   np.zeros((pad, 3), F32)])
            c2 = np.concatenate([_dot3(tile[:cnt], tile[:cnt]),
                                 np.full(pad, np.inf, F32)])
            for g in range(s, cnt, step):
                ds = []
                for u in range(THREE_NN_GROUP):
                    dot = _dot3(points, tile[g + u * lanes][None, :])
                    ds.append(np.maximum((p2 + c2[g + u * lanes])
                                         - F32(2.0) * dot, F32(0.0)))
                at = np.argmin(ds, 0)                 # the first least
                least = np.min(ds, 0)
                idx = t0 + g + at * lanes
                bd, bi = _insert(bd, bi, least, idx, False)
                more = np.zeros(n, bool)
                for u, d in enumerate(ds):
                    more |= (u != at) & (d < bd[:, 2])
                for u, d in enumerate(ds):
                    bd, bi = _insert(bd, bi, np.where(more & (u != at), d,
                                                      np.inf),
                                     np.full(n, t0 + g + u * lanes), False)
        out.append((bd, bi))
    return out


def _k6_select(points, centers, lanes):
    """K6's scan and the lanes' merge on one cloud: (idx (N, 3), d2
    (N, 3))."""
    per_lane = _k6_scan(points, centers, lanes)
    d_lane = np.stack([d for d, _ in per_lane])
    i_lane = np.stack([i for _, i in per_lane])
    o = 1
    while o < lanes:
        pd, pi = d_lane[np.arange(lanes) ^ o], i_lane[np.arange(lanes) ^ o]
        for s in range(lanes):
            for k in range(3):
                d_lane[s], i_lane[s] = _insert(d_lane[s], i_lane[s],
                                               pd[s][:, k], pi[s][:, k], True)
        o <<= 1
    # the butterfly leaves the same three in every lane of a point
    assert (i_lane == i_lane[:1]).all() and (d_lane == d_lane[:1]).all()
    return i_lane[0], d_lane[0]


def _weights(d, dtype):
    d = np.clip(d, F32(1e-10), F32(1e10))
    d0d1, d0d2, d1d2 = d[:, 0] * d[:, 1], d[:, 0] * d[:, 2], d[:, 1] * d[:, 2]
    inv = F32(1.0) / ((d0d1 + d0d2) + d1d2)
    w = np.stack([d1d2 * inv, d0d2 * inv, d0d1 * inv], 1)
    return torch.from_numpy(w).to(dtype).float().numpy()


def _k6_write(idx, w, feats, n, plan, dtype):
    """The output phase on one cloud: the blocks' warps, each taking its
    32 / L points, and every (row, chunk) or (row, channel) a lane writes,
    the values as the kernel forms them."""
    threads, lanes = plan
    m, c = feats.shape
    q = 32 // lanes                              # points a warp
    warps = threads // 32
    per = 16 // torch.empty((), dtype=dtype).element_size()
    out = np.full((n, c), np.nan, F32)
    seen = np.zeros((n, c), np.int64)
    firsts = []
    for base in range(0, n, threads // lanes):
        for warp in range(warps):
            q0 = base + warp * q
            if q0 >= n:
                break
            firsts.append(q0)
            rows, cols = [], []
            nrows = min(q, n - q0)
            if c % per == 0:
                cv = c // per
                dr, dk = divmod(32, cv)
                for lane in range(32):
                    r, ch = divmod(lane, cv)
                    # kUnroll chunks a trip, each stepped the same way
                    for e in range(lane, nrows * cv, 32):
                        assert (r, ch) == divmod(e, cv)
                        rows += [q0 + r] * per
                        cols += range(ch * per, ch * per + per)
                        r, ch = r + dr, ch + dk
                        if ch >= cv:
                            r, ch = r + 1, ch - cv
            else:                                # lanes over a row
                for r in range(nrows):
                    rows += [q0 + r] * c
                    cols += range(c)
            rows, cols = np.asarray(rows), np.asarray(cols)
            f = [feats[idx[rows, k], cols] for k in range(3)]
            out[rows, cols] = (f[0] * w[rows, 0] + f[1] * w[rows, 1]) \
                + f[2] * w[rows, 2]
            np.add.at(seen, (rows, cols), 1)
    assert sorted(firsts) == list(range(0, n, q))   # every warp's once
    assert (seen == 1).all()
    return torch.from_numpy(out).to(dtype)


def _k6_walk(points, centers, feats, dtype=torch.float32, plan=None):
    """K6 on (B, N, 3), (B, M, 3), (B, M, C) float32 numpy with the
    features taken in `dtype`: (out, idx int32, w float32)."""
    b, n, _ = points.shape
    plan = plan or three_nn_plan(b, n)
    f = torch.from_numpy(feats).to(dtype).float().numpy()
    outs, idxs, ws = [], [], []
    for i in range(b):
        idx, d = _k6_select(points[i], centers[i], plan[1])
        w = _weights(d, dtype)
        outs.append(_k6_write(idx, w, f[i], n, plan, dtype))
        idxs.append(idx.astype(np.int32))
        ws.append(w)
    return torch.stack(outs), np.stack(idxs), np.stack(ws)


def _nn_inputs(kind, seed, b, n, m, c):
    rs = np.random.RandomState(seed)
    if kind == "grid":      # integer coordinates: exact equal distances
        pts = rs.randint(-3, 4, (b, n, 3)).astype(F32)
        ctr = rs.randint(-3, 4, (b, m, 3)).astype(F32)
    elif kind == "flat":    # every center on one plane, points far outside
        pts = (rs.randn(b, n, 3) * 3).astype(F32)
        ctr = (rs.randn(b, m, 3) * 0.3).astype(F32)
        ctr[..., 0] = 0.25
    elif kind == "offset":  # far from the origin: the d2 form's rounding
        pts = (50 + rs.randn(b, n, 3) * 0.3).astype(F32)
        ctr = (50 + rs.randn(b, m, 3) * 0.3).astype(F32)
    else:
        pts = (rs.randn(b, n, 3) * 0.3).astype(F32)
        ctr = (rs.randn(b, m, 3) * 0.3).astype(F32)
        if kind == "duplicates" and m > 1:   # ties between lanes
            ctr[:, m // 2:] = ctr[:, :m - m // 2]
            pts[:, :min(n, m)] = ctr[:, :min(n, m)]
    return pts, ctr, rs.randn(b, m, c).astype(F32)


def _check_k6(pts, ctr, feats, dtype, plan=None):
    out, idx, w = _k6_walk(pts, ctr, feats, dtype, plan)
    t = [torch.from_numpy(x) for x in (pts, ctr)]
    ref, ridx, rw = _three_nn_interpolate_plain(
        *t, torch.from_numpy(feats).to(dtype), with_weights=True)
    _bits_equal(out.float().numpy(), ref.float().numpy())
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(idx, ridx.numpy())
    _bits_equal(w, rw.numpy())
    return out, idx


@pytest.mark.parametrize("kind,n,m,c,dt", [
    ("random", 64, 16, 192, torch.float32),      # the main path's levels
    ("random", 256, 64, 192, torch.bfloat16),
    ("duplicates", 200, 64, 7, torch.float32),   # ties across lanes
    ("duplicates", 100, 37, 192, torch.bfloat16),  # M % L != 0
    ("grid", 90, 40, 3, torch.float32),          # exact equal distances
    ("grid", 70, 33, 8, torch.bfloat16),
    ("random", 50, 1, 4, torch.float32),         # M = 1, 2, 3
    ("random", 50, 2, 7, torch.bfloat16),
    ("duplicates", 37, 3, 3, torch.float32),
    ("random", 300, 1100, 12, torch.float32),    # two center tiles
    ("flat", 120, 50, 8, torch.float32),         # points far outside
    ("offset", 150, 300, 8, torch.float32),      # the d2 form's rounding
    ("offset", 80, 40, 7, torch.bfloat16),
])
def test_k6_walk_equals_the_plain_version_and_lion_tpu(kind, n, m, c, dt):
    pts, ctr, feats = _nn_inputs(kind, n + m + c, 2, n, m, c)
    out, idx = _check_k6(pts, ctr, feats, dt)
    if kind == "offset":
        # (p2 + c2) - 2 p.c cancels about four digits at |p| ~ 87: the XLA
        # form's matmul rounds it otherwise and picks other neighbours; the
        # walk is held bit for bit to the plain version above
        return
    want_d, want_i = jinterp.three_nn(jnp.asarray(pts), jnp.asarray(ctr))
    np.testing.assert_array_equal(idx, np.asarray(want_i))
    # the XLA form's matmul distances carry a cancellation error that the
    # weights of 1100 dense centers lift past 1e-5 (5e-5 measured); there
    # the walk is held bit for bit to the plain version above
    if dt == torch.float32 and m <= THREE_NN_TILE:
        want = jinterp._nearest_neighbor_interpolate_xla(
            jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(feats))
        # distances via the matmul form (dot order may differ): fp32
        # rounding, as tests/test_torch_port_ops.py holds them
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("threads,lanes", [(32, 1), (32, 32), (64, 8),
                                           (128, 2), (256, 16), (256, 4)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_k6_walk_on_every_kind_of_plan(threads, lanes, dt):
    """Any valid plan gives the same output: N off the block's and the
    warps' points, C on the chunked path (48 fp32 / 24 bf16 chunks a row)
    and off it."""
    for c in (192, 7):
        pts, ctr, feats = _nn_inputs("duplicates", threads + lanes, 1, 77,
                                     21, c)
        _check_k6(pts, ctr, feats, dt, plan=(threads, lanes))


@pytest.mark.parametrize("n,m,c", [(64, 16, 8), (32, 5, 3), (48, 2, 4)])
def test_k6_walk_equals_the_tpu_kernel_in_interpret_mode(n, m, c):
    pts, ctr, feats = _nn_inputs("random", 3 * n + m, 2, n, m, c)
    out, _, _ = _k6_walk(pts, ctr, feats)
    with pltpu.force_tpu_interpret_mode():
        want = three_nn_interpolate_pallas(jnp.asarray(pts), jnp.asarray(ctr),
                                           jnp.asarray(feats))
    # the TPU kernel gathers bf16 features on the MXU
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_k6_plan_constants_are_the_sources():
    assert (_constant("three_nn.cu", "kMaxThreads"),
            _constant("three_nn.cu", "kMaxLanes"),
            _constant("three_nn.cu", "kTile"),
            _constant("three_nn.cu", "kGroup"),
            _constant("three_nn.cu", "kUnroll")) == (
        THREE_NN_MAX_THREADS, THREE_NN_MAX_LANES, THREE_NN_TILE,
        THREE_NN_GROUP, THREE_NN_UNROLL)


@pytest.mark.parametrize("b", [1, 2, 4, 16, 64])
def test_k6_plan_covers_every_point_once(b):
    """Whole warps, lanes a power of two up to a warp, the blocks' points
    tile [0, N) once; the fewest lanes and the most threads that reach
    the targets; the static shared memory (the centers' tile and a
    triple of indices and weights a point) within 48 KB."""
    assert 16 * (THREE_NN_TILE + THREE_NN_GROUP * THREE_NN_MAX_LANES) \
        + 32 * THREE_NN_MAX_THREADS <= STATIC_SMEM
    for n in list(range(1, 300)) + [1000, 1024, 2048, 4097, 16384]:
        threads, lanes = three_nn_plan(b, n)
        assert threads % 32 == 0 and 32 <= threads <= THREE_NN_MAX_THREADS
        assert lanes & (lanes - 1) == 0 and lanes <= THREE_NN_MAX_LANES
        p = threads // lanes
        blocks = -(-n // p)
        assert blocks * p >= n > (blocks - 1) * p
        if lanes > 1:
            assert b * n * lanes // 2 < THREE_NN_FILL_THREADS
        if threads < THREE_NN_MAX_THREADS:
            assert -(-n * lanes // (2 * threads)) * b < THREE_NN_MIN_BLOCKS


@pytest.mark.parametrize("b", [4, 16])
def test_k6_plan_fills_the_card_at_every_fp_level(b):
    """At the fp32 path's B4 and the bf16 path's B16 every FP level
    launches at least a full wave of blocks on the 132 SMs."""
    for n, _ in FP_LEVELS:
        threads, lanes = three_nn_plan(b, n)
        blocks = -(-n // (threads // lanes)) * b
        assert blocks >= THREE_NN_MIN_BLOCKS == 132


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------
def _sq_dist(c, p):
    d = c[None, :] - p
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _k2_scan(cloud, ctrs, r2, k, tile):
    """A warp's scan for one or two centers at once: [(slots (K,) with -1
    unset, hits)] a center."""
    sel = np.full((len(ctrs), k), -1, np.int64)
    count = [0] * len(ctrs)
    rnd = 32 * BQG_CHUNKS
    for t0 in range(0, len(cloud), tile):
        cnt = min(tile, len(cloud) - t0)
        # the tile padded to whole rounds with points at infinity
        part = np.concatenate([cloud[t0:t0 + cnt], np.full(
            (-(-cnt // rnd) * rnd - cnt, 3), np.inf, F32)])
        j0 = 0
        while j0 < cnt and min(count) < k:
            hits = [[_sq_dist(c, part[j0 + 32 * u:j0 + 32 * u + 32]) < r2
                     for u in range(BQG_CHUNKS)] for c in ctrs]
            if np.any(hits):              # else one vote skips the round
                for u in range(BQG_CHUNKS):
                    j = t0 + j0 + 32 * u + np.arange(32)
                    for a, hit in enumerate(h[u] for h in hits):
                        slot = count[a] + np.cumsum(hit) - hit  # popcounts
                        put = hit & (slot < k)
                        sel[a, slot[put]] = j[put]
                        count[a] += int(hit.sum())
            j0 += rnd
    return list(zip(sel, count))


def _k2_span(nrows, w, team, v):
    """The elements of a pair's span (nrows rows of w = 3 + C floats) that
    a team writes: team thread l takes the v-float chunks l, l + team, ...,
    the (row, column) of each stepped without a divide."""
    es = []
    drow, dch = divmod(v * team, w)
    for lane in range(team):
        row, ch = divmod(v * lane, w)
        for e in range(v * lane, nrows * w, v * team):
            assert (row, ch) == divmod(e, w)
            es.append(e)
            row, ch = row + drow, ch + dch
            if ch >= w:
                row, ch = row + 1, ch - w
    return (np.asarray(es, np.int64)[:, None] + np.arange(v)).ravel()


def _k2_walk(points, centers, feats, radius, k, plan=None):
    """K2 on (B, N, 3), (B, M, 3), (B, N, C) float32 numpy: (rows (B, M,
    K, 3 + C), balls (B, M, K) int32)."""
    b, n, _ = points.shape
    m, c = centers.shape[1], feats.shape[2]
    cpb, threads, tile, _ = plan or bqg_plan(b, n, m, c, k)
    r2 = F32(_r2(radius))
    w = 3 + c
    v = 4 if k * w % 4 == 0 else 1
    out = np.full((b, m * k * w), np.nan, F32)
    seen = np.zeros((b, m * k * w), np.int64)
    balls = np.zeros((b, m, k), np.int32)
    for i in range(b):
        for m0 in range(0, m, cpb):
            ncent = min(cpb, m - m0)
            rows = np.zeros((ncent * k, 4), F32)
            pidx = np.zeros(ncent * k, np.int64)
            scans = []
            for ca in range(0, ncent, 2):                 # a warp's pair
                pair = centers[i, m0 + ca:m0 + min(ca + 2, ncent)]
                scans += _k2_scan(points[i], pair, r2, k, tile)
            for cc, (sel, count) in enumerate(scans):
                found = min(count, k)
                assert (sel[:found] >= 0).all() and (sel[found:] < 0).all()
                sel[found:] = sel[0] if found else 0
                pidx[cc * k:cc * k + k] = sel
                rows[cc * k:cc * k + k, :3] = points[i, sel] \
                    - centers[i, m0 + cc]
                balls[i, m0 + cc] = sel
            # the pairs' spans, each written by a team: the warp that
            # scanned it, or the whole block when it holds one pair
            team = threads if cpb <= 2 else 32
            pairs = [(0, ncent)] if cpb <= 2 else [
                (ca, min(2, ncent - ca)) for ca in range(0, ncent, 2)]
            for ca, nc in pairs:
                es = _k2_span(nc * k, w, team, v)
                row, ch = np.divmod(es, w)
                row += ca * k
                val = np.where(ch < 3, rows[row, np.minimum(ch, 2)],
                               feats[i, pidx[row], np.maximum(ch - 3, 0)]
                               if c else F32(0))
                at = (m0 + ca) * k * w + es
                out[i, at] = val
                np.add.at(seen[i], at, 1)
    assert (seen == 1).all()
    return out.reshape(b, m, k, w), balls


def _bqg_inputs(seed, b, n, m, c):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(b, n, 3) * 0.3).astype(F32)
    ctr = pts[:, rs.choice(n, m, replace=m > n)].copy()
    ctr[:, 0] = 5.0                                  # an empty ball
    return pts, ctr, rs.randn(b, n, c).astype(F32)


def _check_k2(pts, ctr, feats, radius, k, plan=None, jax_ref=True):
    out, balls = _k2_walk(pts, ctr, feats, radius, k, plan)
    t = [torch.from_numpy(x) for x in (pts, ctr, feats)]
    np.testing.assert_array_equal(
        balls, _ball_query_plain(t[1], t[0], radius, k).numpy())
    _bits_equal(out, _ball_query_group_plain(*t, radius, k).numpy())
    if jax_ref:
        want = jpoints.ball_query_group(jnp.asarray(pts), jnp.asarray(ctr),
                                        jnp.asarray(feats), radius, k, True)
        _bits_equal(out, np.asarray(want))
    return out, balls


@pytest.mark.parametrize("n,m,c,radius,k", [
    (256, 64, 128, 0.4, 32),                       # the main path's levels
    (64, 16, 192, 0.8, 32),
    (300, 40, 0, 0.2, 32),                         # C = 0
    (200, 50, 5, 0.25, 16),                        # K (3 + C) % 4 != 0
    (500, 30, 32, 0.15, 32),
    (130, 20, 64, 0.5, 8),
    (5000, 24, 3, 0.1, 32),                        # beyond one cloud tile
])
def test_k2_walk_equals_the_plain_version_and_lion_tpu(n, m, c, radius, k):
    pts, ctr, feats = _bqg_inputs(n + m + c, 2, n, m, c)
    out, balls = _check_k2(pts, ctr, feats, radius, k)
    assert (balls[:, 0] == 0).all()                # the empty ball
    assert (out[:, 0, :, 3:] == feats[:, None, 0]).all()


def test_k2_walk_exact_and_more_than_k_hits_and_the_last_chunk():
    """A ball with exactly K hits, one with more (the scan stops after the
    round that reaches K), one whose hits lie only in the last partial
    chunk, and K > N (padded with the first hit)."""
    rs = np.random.RandomState(5)
    k, n = 16, 300                     # 300 = 2 rounds of 128 + 44 points
    pts = (rs.rand(1, n, 3) * 10 + 2).astype(F32)     # all far from 0
    ctr = np.zeros((1, 4, 3), F32)
    ctr[0, 1] = 20.0
    ctr[0, 2] = -20.0
    ctr[0, 3] = 40.0
    pts[0, 5:5 + k] = 0.01 * rs.randn(k, 3)            # exactly K at 0
    pts[0, 100:100 + 3 * k] = 20.0 + 0.01 * rs.randn(3 * k, 3)   # 3K at 20
    pts[0, 289:299] = -20.0 + 0.01 * rs.randn(10, 3)   # the last chunk
    feats = rs.randn(1, n, 6).astype(F32)
    out, balls = _check_k2(pts, ctr, feats, 0.5, k)
    np.testing.assert_array_equal(balls[0, 0], np.arange(5, 5 + k))
    np.testing.assert_array_equal(balls[0, 1], np.arange(100, 100 + k))
    np.testing.assert_array_equal(
        balls[0, 2], np.r_[np.arange(289, 299), [289] * (k - 10)])
    assert (balls[0, 3] == 0).all()                    # an empty ball
    # K > N: every point in the ball, then the first hit again (the XLA
    # form refuses K > N)
    small = pts[:, 5:12].copy()
    _, balls = _check_k2(small, ctr[:, :1], feats[:, 5:12], 0.5, 12,
                         jax_ref=False)
    np.testing.assert_array_equal(balls[0, 0], np.r_[np.arange(7), [0] * 5])


@pytest.mark.parametrize("cpb,threads", [(1, 32), (32, 256), (8, 64),
                                         (4, 128)])
@pytest.mark.parametrize("c", [0, 5, 32])
def test_k2_walk_on_every_kind_of_plan(cpb, threads, c):
    """Any valid plan gives the same rows: M off the block's centers, a
    tile shorter than the cloud, both the 4-float and 1-float writes."""
    pts, ctr, feats = _bqg_inputs(cpb + c, 2, 700, 37, c)
    tile = 256
    plan = (cpb, threads, tile, bqg_smem(cpb, 32, tile, threads))
    _check_k2(pts, ctr, feats, 0.2, 32, plan=plan)


# C = 0 is held to the plain version and the XLA form above: the TPU
# kernel's interpreter refuses a zero-width feature block
@pytest.mark.parametrize("c", [5, 32, 64, 128, 192])
def test_k2_walk_equals_the_tpu_kernel_in_interpret_mode(c):
    pts, ctr, feats = _bqg_inputs(c + 1, 1, 128, 16, c)
    out, _ = _k2_walk(pts, ctr, feats, 0.5, 8)
    with pltpu.force_tpu_interpret_mode():
        want = ball_query_group_pallas(jnp.asarray(pts), jnp.asarray(ctr),
                                       jnp.asarray(feats), 0.5, 8)
    # the TPU kernel gathers through a bf16 one-hot matmul on the MXU
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-2, atol=2e-2)


def _source(name):
    return " ".join((CSRC / name).read_text().split())


def _limits_are_the_sources(name):
    """A ball query's limits and the shared scan's constants."""
    assert (_constant(name, "kMaxThreads"), _constant(name, "kMaxCenters"),
            _constant("ball_scan.cuh", "kTileN"),
            _constant("ball_scan.cuh", "kChunks"),
            _constant(name, "kSmemMax")) == (
        BQG_MAX_THREADS, BQG_MAX_CENTERS, BQG_TILE, BQG_CHUNKS, BQG_SMEM_MAX)
    assert "constexpr int kRound = 32 * kChunks;" in _source("ball_scan.cuh")
    assert '#include "ball_scan.cuh"' in _source(name)


def test_k2_plan_constants_are_the_sources():
    _limits_are_the_sources("ball_query_group.cu")
    src = _source("ball_query_group.cu")
    assert ("return 16LL * (tile + kRound) + 16LL * (threads / 32) * 2 * k "
            "+ 4LL * cpb * k + 4LL * cpb;") in src
    assert bqg_smem(3, 5, 7, 64) == 16 * (7 + 32 * BQG_CHUNKS) \
        + 16 * 2 * 2 * 5 + 4 * 3 * 5 + 4 * 3


@pytest.mark.parametrize("b", [1, 4, 16])
def test_k2_plan_covers_every_center_once(b):
    """Whole warps, at least one a pair of centers scanned at once (up to
    eight warps); centers a block
    a power of two up to the limit and below 2 M; the blocks tile [0, M)
    once; the tile covers the cloud or is the limit; shared memory within
    the H100's."""
    for m in list(range(1, 70)) + [256, 1000, 1024]:
        for n, c, k in ((m + 3, 32, 32), (2048, 0, 8), (5000, 192, 64)):
            cpb, threads, tile, smem = bqg_plan(b, n, m, c, k)
            assert threads % 32 == 0 and 32 <= threads <= BQG_MAX_THREADS
            assert threads >= 32 * min(-(-cpb // 2), BQG_MAX_THREADS // 32)
            assert cpb & (cpb - 1) == 0 and 1 <= cpb <= BQG_MAX_CENTERS
            assert cpb == 1 or cpb < 2 * m
            blocks = -(-m // cpb)
            assert blocks * cpb >= m > (blocks - 1) * cpb
            assert tile == min(n, BQG_TILE)
            assert smem == bqg_smem(cpb, k, tile, threads) <= SMEM_BYTES
            assert threads == BQG_MAX_THREADS or cpb > 2
    with pytest.raises(ValueError):
        bqg_plan(b, 100, 10, 3, 20000)            # K beyond shared memory


@pytest.mark.parametrize("b", [4, 16])
def test_k2_plan_fills_the_card_at_every_sa_level(b):
    """At B4 and B16 every SA level launches a full wave of blocks, but
    for the 64 centers of M16 at B4, which run one a block; the plans fit
    four blocks an SM at N2048."""
    assert BQG_MIN_BLOCKS >= 132
    for n, m, c, _ in SA_LEVELS:   # a warp a pair; a block of one pair
        cpb, threads, tile, smem = bqg_plan(b, n, m, c, 32)
        blocks = -(-m // cpb) * b
        assert blocks >= 132 or (cpb == 1 and blocks == m * b)
        assert threads == min(BQG_MAX_THREADS, 32 * -(-cpb // 2)) or cpb <= 2
        if n == 2048:   # an SM's 228 KB, less 1 KB a block
            assert 4 * (smem + 1024) <= 228 * 1024


# --------------------------------------------------------------------------
# K11 and K13: K2's scan with their own epilogues
# --------------------------------------------------------------------------
def _fill(sel, count, k):
    """A scanned ball's slots (-1 unset) filled as the kernels fill them:
    slots past the hit count copy slot 0, an empty ball takes point 0."""
    found = min(count, k)
    assert (sel[:found] >= 0).all() and (sel[found:] < 0).all()
    sel = sel.copy()
    sel[found:] = sel[0] if found else 0
    return sel


def _k11_walk(points, centers, radius, k, plan=None):
    """K11 on (B, N, 3), (B, M, 3) float32 numpy: balls (B, M, K) int32.
    Blocks of cpb centers; each warp scans a pair and writes its 2 K slots
    (one span of the output), lane l taking the v-int chunks l, l + 32,
    ..., each within one center's slots."""
    b, n, _ = points.shape
    m = centers.shape[1]
    cpb, _, tile, _ = plan or bq_plan(b, n, m, k)    # any threads
    r2 = F32(_r2(radius))
    v = 4 if k % 4 == 0 else 1
    out = np.full((b, m * k), -1, np.int64)
    seen = np.zeros((b, m * k), np.int64)
    for i in range(b):
        for m0 in range(0, m, cpb):
            end = min(m0 + cpb, m)
            for ca in range(m0, end, 2):
                nc = min(2, end - ca)
                slots = np.concatenate([_fill(sel, count, k) for sel, count
                                        in _k2_scan(points[i],
                                                    centers[i, ca:ca + nc],
                                                    r2, k, tile)])
                for lane in range(32):
                    for e in range(v * lane, nc * k, 32 * v):
                        assert e // k == (e + v - 1) // k   # one center
                        out[i, ca * k + e:ca * k + e + v] = slots[e:e + v]
                        seen[i, ca * k + e:ca * k + e + v] += 1
    assert (seen == 1).all()
    return out.reshape(b, m, k).astype(np.int32)


def _check_k11(pts, ctr, radius, k, plan=None, jax_ref=True):
    balls = _k11_walk(pts, ctr, radius, k, plan)
    np.testing.assert_array_equal(
        balls, _ball_query_plain(torch.from_numpy(ctr), torch.from_numpy(pts),
                                 radius, k).numpy())
    if jax_ref:
        np.testing.assert_array_equal(balls, np.asarray(jpoints.ball_query(
            jnp.asarray(ctr), jnp.asarray(pts), radius, k)))
    return balls


def _bf16(x):
    """float32 values rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(
        torch.bfloat16).float().numpy()


def _k13_walk(points, centers, feats, radius, k, bf16=False, plan=None):
    """K13 on float32 numpy inputs (features holding bf16 values when
    `bf16`): (B, K, 3 + C, M) float32 (bf16 values when `bf16`). Block
    (centers m0.., slots s0..s1) scans its centers up to its last slot s1
    (K2's scan, s1 slots a center) and fills its slots; its warps take the
    units (a slot's feature rows in chunks, the first with the 3 coordinate
    rows, which lane j = center j writes) in turn. Where kTile divides C,
    M and cpb, a unit's rows go out as kTile x kTile tiles, each a lane's:
    kTile rows (centers) loaded, kTile columns (channels) stored; else a
    unit is staged with lanes along the channels into a (kRows, cpb + 1)
    buffer and written with lanes along (row, center)."""
    b, n, _ = points.shape
    m, c = centers.shape[1], feats.shape[2]
    size = 2 if bf16 else 4
    cpb, groups, threads, tile, _ = plan or bqg_cf_plan(b, n, m, c, k, size)
    assert cpb & (cpb - 1) == 0 and 1 <= groups <= k and threads % 32 == 0
    r2 = F32(_r2(radius))
    q_ = _constant("ball_query_group_cf.cu", "kTile")
    tiled = c % q_ == 0 and m % q_ == 0 and cpb % q_ == 0
    quads = _constant("ball_query_group_cf.cu", "kQuads")
    rows = quads * q_ if tiled else _constant("ball_query_group_cf.cu",
                                              "kRows")
    stride, shift = cpb + 1, cpb.bit_length() - 1
    ks = -(-k // groups)
    rnd = _bf16 if bf16 else (lambda x: x)
    out = np.full((b, k, 3 + c, m), np.nan, F32)
    seen = np.zeros((b, k, 3 + c, m), np.int64)

    def put(i, s, row, col, val):
        out[i, s, row, col] = val
        np.add.at(seen[i, s], (row, col), 1)

    for i in range(b):
        for m0 in range(0, m, cpb):
            ncent = min(cpb, m - m0)
            for s0 in range(0, k, ks):                 # no group empty
                s1 = min(k, s0 + ks)
                sel = np.concatenate([
                    [_fill(s, count, s1) for s, count in _k2_scan(
                        points[i], centers[i, m0 + ca:m0 + min(ca + 2, ncent)],
                        r2, s1, tile)] for ca in range(0, ncent, 2)])
                for s in range(s0, s1):
                    for ch0 in range(0, max(c, 1), rows):   # a warp's unit
                        if ch0 == 0:   # coordinates: lane j, center j
                            j = np.arange(ncent)
                            for d in range(3):
                                put(i, s, d, m0 + j, rnd(
                                    points[i, sel[j, s], d]
                                    - centers[i, m0 + j, d]))
                        if tiled:      # tile t: group t % G, quad t // G
                            t = np.arange(cpb // q_ * quads)
                            j0 = t % (cpb // q_) * q_
                            c0 = ch0 + t // (cpb // q_) * q_
                            live = (j0 < ncent) & (c0 < c)
                            j0, c0 = j0[live], c0[live]
                            e = np.arange(q_)
                            jj = (j0[:, None, None] + e[None, None, :])
                            cc = (c0[:, None, None] + e[None, :, None])
                            # row e of a tile loaded, column e stored
                            put(i, s, 3 + cc, m0 + jj,
                                feats[i, sel[jj, s], cc])
                            continue
                        nr = max(0, min(rows, c - ch0))
                        buf = np.full(rows * stride, np.nan, F32)
                        lane, j = np.arange(nr)[:, None], np.arange(ncent)
                        buf[lane * stride + j] = feats[i, sel[j, s],
                                                       ch0 + lane]
                        e = np.arange(nr * cpb)      # lanes' (row, center)
                        r, j = e >> shift, e & (cpb - 1)
                        r, j = r[j < ncent], j[j < ncent]
                        put(i, s, 3 + ch0 + r, m0 + j, buf[r * stride + j])
    assert (seen == 1).all()
    return out


def _check_k13(pts, ctr, feats, radius, k, bf16=False, plan=None,
               jax_ref=True):
    if bf16:
        feats = _bf16(feats)
    out = _k13_walk(pts, ctr, feats, radius, k, bf16, plan)
    tf = torch.from_numpy(feats)
    tf = tf.to(torch.bfloat16) if bf16 else tf
    want = _ball_query_group_cf_plain(torch.from_numpy(pts),
                                      torch.from_numpy(ctr), tf, radius, k)
    assert want.dtype == tf.dtype
    _bits_equal(out, want.float().numpy())
    if jax_ref:
        jf = jnp.asarray(feats).astype(jnp.bfloat16 if bf16 else jnp.float32)
        got = jpoints.ball_query_group_cf(jnp.asarray(pts), jnp.asarray(ctr),
                                          jf, radius, k)
        _bits_equal(out, np.asarray(got.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("n,m,radius,k", [
    (256, 64, 0.4, 32),                            # the main path's levels
    (64, 16, 0.8, 32),
    (200, 50, 0.25, 13),                           # K % 4 != 0
    (130, 20, 0.5, 8),
    (4100, 9, 0.1, 16),                            # beyond one cloud tile
])
def test_k11_walk_equals_the_plain_version_and_lion_tpu(n, m, radius, k):
    pts, ctr, _ = _bqg_inputs(n + m, 2, n, m, 0)
    balls = _check_k11(pts, ctr, radius, k)
    assert (balls[:, 0] == 0).all()                # the empty ball


def test_k11_and_k13_walks_exact_and_more_than_k_hits_and_the_last_chunk():
    """K2's hand-made balls (exactly K hits, 3K, hits only in the last
    partial chunk, empty) through K11's and K13's epilogues, and K > N
    (padded with the first hit)."""
    rs = np.random.RandomState(5)
    k, n = 16, 300                     # 300 = 2 rounds of 128 + 44 points
    pts = (rs.rand(1, n, 3) * 10 + 2).astype(F32)     # all far from 0
    ctr = np.zeros((1, 4, 3), F32)
    ctr[0, 1], ctr[0, 2], ctr[0, 3] = 20.0, -20.0, 40.0
    pts[0, 5:5 + k] = 0.01 * rs.randn(k, 3)            # exactly K at 0
    pts[0, 100:100 + 3 * k] = 20.0 + 0.01 * rs.randn(3 * k, 3)   # 3K at 20
    pts[0, 289:299] = -20.0 + 0.01 * rs.randn(10, 3)   # the last chunk
    feats = rs.randn(1, n, 6).astype(F32)
    balls = _check_k11(pts, ctr, 0.5, k)
    np.testing.assert_array_equal(balls[0, 0], np.arange(5, 5 + k))
    np.testing.assert_array_equal(balls[0, 1], np.arange(100, 100 + k))
    np.testing.assert_array_equal(
        balls[0, 2], np.r_[np.arange(289, 299), [289] * (k - 10)])
    assert (balls[0, 3] == 0).all()                    # an empty ball
    out = _check_k13(pts, ctr, feats, 0.5, k)
    np.testing.assert_array_equal(out[0, :, 3:, 2], feats[0, balls[0, 2]])
    # K > N: every point in the ball, then the first hit again (the XLA
    # form refuses K > N)
    small = pts[:, 5:12].copy()
    balls = _check_k11(small, ctr[:, :1], 0.5, 12, jax_ref=False)
    np.testing.assert_array_equal(balls[0, 0], np.r_[np.arange(7), [0] * 5])
    _check_k13(small, ctr[:, :1], feats[:, 5:12], 0.5, 12, jax_ref=False)


@pytest.mark.parametrize("cpb,threads", [(1, 32), (32, 256), (8, 64),
                                         (4, 128)])
@pytest.mark.parametrize("k", [12, 13])
def test_k11_walk_on_every_kind_of_plan(cpb, threads, k):
    """Any valid plan gives the same balls: M off the block's centers, a
    tile shorter than the cloud, both the 16-byte and the single writes."""
    pts, ctr, _ = _bqg_inputs(cpb + k, 2, 700, 37, 0)
    tile = 256
    _check_k11(pts, ctr, 0.2, k, (cpb, threads, tile, bq_smem(cpb, k, tile)),
               jax_ref=False)


def test_k11_walk_equals_the_tpu_kernel_in_interpret_mode():
    pts, ctr, _ = _bqg_inputs(3, 2, 128, 16, 0)
    balls = _k11_walk(pts, ctr, 0.5, 8)
    with pltpu.force_tpu_interpret_mode():
        want = ball_query_pallas(jnp.asarray(ctr), jnp.asarray(pts), 0.5, 8)
    np.testing.assert_array_equal(balls, np.asarray(want))


@pytest.mark.parametrize("n,m,c,radius,k", [
    (256, 64, 128, 0.4, 32),                       # the CF shapes' SA2
    (300, 40, 0, 0.2, 16),                         # C = 0
    (200, 51, 5, 0.25, 13),                        # K (3 + C) % 4 != 0, M odd
    (4100, 10, 37, 0.1, 8),                        # beyond a tile; 2 chunks
])
@pytest.mark.parametrize("bf16", [False, True])
def test_k13_walk_equals_the_plain_version_and_lion_tpu(n, m, c, radius, k,
                                                        bf16):
    pts, ctr, feats = _bqg_inputs(n + m + c, 2, n, m, c)
    out = _check_k13(pts, ctr, feats, radius, k, bf16)
    if c:                                          # the empty ball
        want = _bf16(feats[:, 0]) if bf16 else feats[:, 0]
        assert (out[:, :, 3:, 0] == want[:, None]).all()


@pytest.mark.parametrize("cpb,groups,threads", [
    (1, 1, 32), (32, 1, 256), (8, 4, 64), (16, 32, 128), (2, 3, 96)])
@pytest.mark.parametrize("bf16", [False, True])
def test_k13_walk_on_every_kind_of_plan(cpb, groups, threads, bf16):
    """Any valid plan gives the same output: M off the block's centers, a
    tile shorter than the cloud, slot groups that do not divide K, blocks
    of one center; the staged rows (C = 5) and the tiled ones (C = 16,
    M = 40, where the block allows)."""
    tile, k, size = 256, 32, 2 if bf16 else 4
    plan = (cpb, groups, threads, tile,
            bqg_cf_smem(cpb, k, tile, threads, size))
    for m, c in ((38, 5), (40, 16)):
        pts, ctr, feats = _bqg_inputs(cpb + groups + c, 1, 700, m, c)
        _check_k13(pts, ctr, feats, 0.2, k, bf16, plan, jax_ref=False)


def test_k11_plan_constants_are_the_sources():
    _limits_are_the_sources("ball_query.cu")
    assert ("return 16LL * (tile + kRound) + 4LL * cpb * k + 4LL * cpb;"
            in _source("ball_query.cu"))
    assert bq_smem(3, 5, 7) == 16 * (7 + 32 * BQG_CHUNKS) + 4 * 3 * 5 + 4 * 3


def test_k13_plan_constants_are_the_sources():
    _limits_are_the_sources("ball_query_group_cf.cu")
    assert _constant("ball_query_group_cf.cu", "kRows") == CF_ROWS
    src = _source("ball_query_group_cf.cu")
    assert ("const long long bufs = (threads / 32) * kRows * (cpb + 1LL) * "
            "size; const long long cloud = 16LL * (tile + kRound); return "
            "cloud > bufs ? cloud : (bufs + 15) / 16 * 16;") in src
    assert ("return scan_area(cpb, tile, threads, size) + 8LL * cpb * k + "
            "4LL * cpb;") in src
    assert bqg_cf_smem(4, 5, 7, 64, 2) == 16 * (7 + 32 * BQG_CHUNKS) \
        + 8 * 4 * 5 + 4 * 4
    assert bqg_cf_smem(32, 5, 7, 256, 4) == 8 * 32 * 33 * 4 + 8 * 32 * 5 \
        + 4 * 32
    assert bqg_cf_smem(32, 5, 7, 256, 2) == 8 * 32 * 33 * 2 + 8 * 32 * 5 \
        + 4 * 32


# the three ball queries take K = 32 on the main path; others as the tests'
PLAN_CASES = ((32, 32), (2048, 8), (5000, 64), (300, 13))


@pytest.mark.parametrize("b", [1, 4, 16])
def test_k11_plan_covers_every_center_once(b):
    """Centers a block a power of two up to the limit and below 2 M; the
    blocks tile [0, M) once; the most threads (a warp a pair of centers,
    the rest staging the cloud); the tile covers the cloud or is the
    limit; shared memory within the H100's."""
    for m in list(range(1, 70)) + [256, 1000, 1024]:
        for n, k in ((m + 3, 32),) + PLAN_CASES:
            cpb, threads, tile, smem = bq_plan(b, n, m, k)
            assert cpb & (cpb - 1) == 0 and 1 <= cpb <= BQG_MAX_CENTERS
            assert cpb == 1 or cpb < 2 * m
            blocks = -(-m // cpb)
            assert blocks * cpb >= m > (blocks - 1) * cpb
            assert threads == BQG_MAX_THREADS
            assert tile == min(n, BQG_TILE)
            assert smem == bq_smem(cpb, k, tile) <= SMEM_BYTES
            assert blocks * b >= BQG_MIN_BLOCKS or cpb == 1 \
                or cpb == BQG_MAX_CENTERS
    with pytest.raises(ValueError):
        bq_plan(b, 100, 10, 60000)                 # K beyond shared memory


@pytest.mark.parametrize("b", [1, 4, 16])
def test_k13_plan_covers_every_element_once(b):
    """Centers a block a power of two, below 2 M unless at the sector's
    floor; the blocks tile [0, M) once; the slot groups tile [0, K),
    none empty; shared memory (the tile, two
    transposes, the slots) within the H100's."""
    for m in list(range(1, 40)) + [256, 1000, 1024]:
        for n, k in PLAN_CASES:
            for c in (0, 5, 32, 192):
                for size in (4, 2):
                    cpb, groups, threads, tile, smem = bqg_cf_plan(
                        b, n, m, c, k, size)
                    assert cpb & (cpb - 1) == 0
                    assert 1 <= cpb <= BQG_MAX_CENTERS
                    assert cpb <= CF_MIN_CENTERS or cpb < 2 * m
                    blocks = -(-m // cpb)
                    assert blocks * cpb >= m > (blocks - 1) * cpb
                    assert 1 <= groups <= k
                    assert -(-k // -(-k // groups)) == groups   # none empty
                    assert threads == BQG_MAX_THREADS
                    assert tile == min(n, BQG_TILE)
                    assert smem == bqg_cf_smem(cpb, k, tile, threads,
                                               size) <= SMEM_BYTES
    with pytest.raises(ValueError):
        bqg_cf_plan(b, 100, 10, 5, 60000, 4)       # K beyond shared memory


@pytest.mark.parametrize("b", [4, 16])
def test_k11_and_k13_plans_fill_the_card_at_every_sa_level(b):
    """At B4 and B16 every SA level launches two blocks an SM for K11 but
    for M16's 64 centers at B4 and 256 at B16, which run one a block, and
    CF_MIN_BLOCKS for K13 (fp32 and bf16; the slots split in groups once
    a block holds CF_MIN_CENTERS); K13 keeps four blocks an SM at
    N2048."""
    for n, m, c, _ in SA_LEVELS:
        cpb = bq_plan(b, n, m, 32)[0]
        blocks = -(-m // cpb) * b
        assert blocks >= BQG_MIN_BLOCKS or (cpb == 1 and blocks == m * b)
        for size in (4, 2):
            cpb, groups, _, _, smem = bqg_cf_plan(b, n, m, c, 32, size)
            blocks = -(-m // cpb) * b * groups
            assert blocks >= CF_MIN_BLOCKS or groups == 32
            assert cpb >= CF_MIN_CENTERS
            if groups > 1:           # the fewest groups, at the floor
                assert cpb == CF_MIN_CENTERS
                assert -(-m // cpb) * b * (groups // 2) < CF_MIN_BLOCKS
            if n == 2048:   # an SM's 228 KB, less 1 KB a block
                assert 4 * (smem + 1024) <= 228 * 1024
