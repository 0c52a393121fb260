"""The furthest point sampling kernel (K1, csrc/fps.cu) walked in numpy on
the CPU, against the plain version and the JAX package.

The kernel runs only on the card (tests/test_torch_port_gpu.py); this file
holds its logic and plan:
  * the walk: the plan's T threads own P points each, strided (point
    i T + t for thread t), whose running minimum distances are updated with
    the unfused ((dx*dx + dy*dy) + dz*dz); a thread keeps its first maximum;
    a warp's argmax is the maximum of the distances' float bits, then the
    least index over the lanes that hold it; a block of several warps
    writes each warp's (bits, index) to the slot row of the pick's parity
    and every warp folds the row with the same two reductions. Its indices
    and centers equal `_fps_plain`'s and `lion_tpu`'s (the XLA form the
    JAX package runs on the CPU, and its Pallas kernel in interpret mode);
  * the plan (threads, P, shared bytes) fits for every N the wrapper takes,
    and its constants are the source's.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu.ops import points as jpoints
from lion_tpu.ops.pallas.fps import furthest_point_sample_pallas

from lion_tpu_torch.ops.points import (FPS_BLOCK_P, FPS_MAX_N, FPS_MAX_P,
                                       FPS_MAX_THREADS, FPS_WARP_MAX_N,
                                       _fps_plain, fps_plan)

from test_torch_port_sample import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"
NONE = 0xFFFFFFFF           # the reductions' neutral index
SMEM_BYTES = 232448         # a block's shared memory on the H100
SLOTS_BYTES = 2 * 32 * 8    # the two slot rows of (bits, index)
# (N, M) of the main path's four levels (models/priors.py)
LEVELS = [(2048, 1024), (1024, 256), (256, 64), (64, 16)]


def _fps_walk(xyz, m):
    """K1 on one cloud (N, 3) float32: (indices (M,), centers (M, 3))."""
    n = xyz.shape[0]
    threads, p, _ = fps_plan(n)
    warps = threads // 32
    j = np.arange(p)[:, None] * threads + np.arange(threads)[None, :]
    valid = j < n
    pts = np.zeros((p, threads, 3), np.float32)
    pts[valid] = xyz[j[valid]]
    # points past N hold +0 and an index >= N: they lose every tie
    dist = np.where(valid, np.float32(np.inf), np.float32(0.0))
    # the slot rows: (bits, index, the pick that wrote them) per warp
    slots = np.zeros((2, warps, 3), np.int64)
    picks = [0]
    last = 0
    for s in range(1, m):
        c = xyz[last]                              # the shared copy's bits
        d = [pts[..., a] - c[a] for a in range(3)]
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        assert d2.dtype == np.float32
        dist = np.minimum(dist, d2)
        bits = dist.view(np.uint32).astype(np.int64)
        key = bits.max(0)                          # (T,)
        first = np.argmax(bits == key, axis=0)     # a thread's first maximum
        best = j[first, np.arange(threads)]
        lanes_key = key.reshape(warps, 32)
        lanes_best = best.reshape(warps, 32)
        wkey = lanes_key.max(1)
        wlast = np.where(lanes_key == wkey[:, None], lanes_best, NONE).min(1)
        if warps > 1:
            row = slots[s & 1]
            row[:] = np.stack([wkey, wlast, np.full(warps, s)], 1)
            # after the barrier every warp reads the whole row, all of it
            # written at this pick (the other row may hold pick s +- 1)
            assert (row[:, 2] == s).all()
            bkey = row[:, 0].max()
            last = int(np.where(row[:, 0] == bkey, row[:, 1], NONE).min())
        else:
            last = int(wlast[0])
        assert last < n
        picks.append(last)
    idx = np.asarray(picks, np.int64)
    return idx, xyz[idx]


def _walk(xyz, m):
    out = [_fps_walk(c, m) for c in xyz]
    return (np.stack([i for i, _ in out]).astype(np.int32),
            np.stack([c for _, c in out]))


def _cloud(kind, seed, b, n):
    rs = np.random.RandomState(seed)
    if kind == "grid":      # integer coordinates: many exact ties
        return rs.randint(-3, 4, (b, n, 3)).astype(np.float32)
    xyz = (rs.randn(b, n, 3) * 0.3).astype(np.float32)
    if kind == "duplicates":
        xyz[:, n // 2:n // 2 + min(4, n // 2)] = xyz[:, :min(4, n // 2)]
        xyz[:, -1] = xyz[:, 0]
    return xyz


def _assert_same(xyz, m, got):
    idx, ctr = got
    pidx, pctr = _fps_plain(torch.from_numpy(xyz), m)
    np.testing.assert_array_equal(idx, pidx.numpy())
    assert np.array_equal(ctr.view(np.int32), pctr.numpy().view(np.int32))
    want = np.asarray(jpoints.furthest_point_sample_idx(jnp.asarray(xyz), m))
    np.testing.assert_array_equal(idx, want)


@pytest.mark.parametrize("kind,n,m", [
    ("random", 2048, 1024), ("random", 1024, 256), ("random", 256, 64),
    ("random", 64, 16),                         # the main path's levels
    ("duplicates", 2048, 1024), ("grid", 2048, 1024), ("grid", 1024, 1024),
    ("grid", 300, 300),                         # M = N: every point taken
    ("duplicates", 1000, 500), ("random", 300, 77),  # N % block != 0
    ("grid", 20, 20), ("random", 7, 5), ("duplicates", 31, 31),  # N < 32
    ("grid", 257, 200), ("random", 4000, 64)])
def test_fps_walk_equals_the_plain_version_and_lion_tpu(kind, n, m):
    xyz = _cloud(kind, n + m, 2, n)
    _assert_same(xyz, m, _walk(xyz, m))


@pytest.mark.parametrize("kind,n,m", [("grid", 64, 16), ("random", 128, 37)])
def test_fps_walk_equals_the_tpu_kernel_in_interpret_mode(kind, n, m):
    xyz = _cloud(kind, 3 * n, 2, n)
    idx, ctr = _walk(xyz, m)
    with pltpu.force_tpu_interpret_mode():
        kidx, kctr = furthest_point_sample_pallas(jnp.asarray(xyz), m)
    np.testing.assert_array_equal(idx, np.asarray(kidx))
    kctr = np.transpose(np.asarray(kctr), (1, 2, 0))
    assert np.array_equal(ctr.view(np.int32), kctr.view(np.int32))


def test_grid_ties_are_many_and_the_rule_decides_them():
    """On integer coordinates most picks tie: the walk's lowest-index rule
    is what makes it equal the plain version there."""
    xyz = _cloud("grid", 1, 1, 2048)[0]
    idx, _ = _fps_walk(xyz, 256)
    ties = 0
    dist = np.full(2048, np.inf, np.float32)
    for s in range(1, 256):
        d = xyz - xyz[idx[s - 1]]
        dist = np.minimum(dist, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                          + d[:, 2] * d[:, 2])
        ties += int((dist == dist.max()).sum() > 1)
        assert idx[s] == int(np.argmax(dist))
    assert ties > 100


def _constant(name):
    expr = re.search(rf"constexpr int {name} = ([^;]+);",
                     (CSRC / "fps.cu").read_text()).group(1)
    return int(expr.split("//")[0])


def test_fps_plan_constants_are_the_sources():
    assert (_constant("kMaxThreads"), _constant("kWarpMaxN"),
            _constant("kBlockP"), _constant("kMaxP")) == (
        FPS_MAX_THREADS, FPS_WARP_MAX_N, FPS_BLOCK_P, FPS_MAX_P)


def test_fps_plan_fits_every_n_the_wrapper_takes():
    """Every N from 1 to the limit (which covers the former limit of
    16 N <= 227 KB, N <= 14528): whole warps, at most 1024 threads, P a
    power of two, every point owned once by the fewest warps, one warp up
    to 256 points, the shared copy and the slot rows within 227 KB."""
    assert FPS_MAX_N >= 14528
    for n in range(1, FPS_MAX_N + 1):
        threads, p, smem = fps_plan(n)
        assert threads % 32 == 0 and 32 <= threads <= FPS_MAX_THREADS
        assert p & (p - 1) == 0 and 1 <= p <= FPS_MAX_P
        assert threads * p >= n > (threads - 32) * p
        assert (threads == 32) == (n <= FPS_WARP_MAX_N)
        assert threads == 32 or p >= FPS_BLOCK_P
        assert smem == 12 * n and smem + SLOTS_BYTES <= SMEM_BYTES
    for n in (0, FPS_MAX_N + 1):
        with pytest.raises(ValueError):
            fps_plan(n)


def test_fps_plan_at_the_main_path_levels():
    """The two small levels run on one warp (no barrier), and every level
    keeps at most 8 points a thread, so the points stay in registers."""
    plans = [fps_plan(n)[:2] for n, _ in LEVELS]
    assert all(p <= 8 for _, p in plans)
    assert [t for t, _ in plans][2:] == [32, 32]

