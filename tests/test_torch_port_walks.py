"""The plans of the fused set abstraction's index-and-recompute walk (K7,
csrc/sa_fused.cu) and of the cell-ordered average voxelization (K3,
csrc/voxelize.cu) on the CPU, and a PyTorch / numpy walk of each plan
against the plain versions and the JAX package.

The kernels run only on the card (tests/test_torch_port_gpu.py); this file
holds what surrounds them:
  * K3: the stable cell order and offsets that the ordering launch builds
    (its warp placing 32 points a round) and the means summed in that
    order, bit-equal to a float32 sum in point order (np.add.at) divided by
    the count;
  * K7: `sa_plan` (tiles divide M, rows fit the fragments, shared memory
    within 227 KB, the constants of the source), and the walk's passes
    (a block's shifted sums over its tiles as one partial, the partials
    merged in the kernel's fixed tree in float64, the GroupNorm fold, the
    rows recomputed from the indices in every pass) against
    `_sa_fused_plain` and the TPU kernel in interpret mode.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lion_tpu_torch.ops.conv3d import GN_EPS, GN_GROUPS
from lion_tpu_torch.ops.points import _ball_query_plain
from lion_tpu_torch.ops.sa_fused import (BLOCKS_SM, BLOCKS_SM_QUERY, LDW,
                                         MAX_LAYERS, RED, SMEM_DYN,
                                         THREADS, _sa_fused_plain, sa_plan,
                                         supports_sa_fused)
from lion_tpu_torch.ops.voxel import (SMEM_MAX, _avg_voxelize_plain,
                                      vox_order_smem)

from test_torch_port_sample import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
CSRC = Path(__file__).resolve().parents[1] / "lion_tpu_torch" / "csrc"


def _constant(src, name):
    """A `constexpr int` of a source, its integer expression evaluated."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);",
                     (CSRC / src).read_text()).group(1)
    assert re.fullmatch(r"[0-9 +*-]+", expr), expr
    return eval(expr)  # noqa: S307 (digits and + - * only)


# ------------------------------------------------------------------ K3
def _cells(vox, r):
    """Flat cell per point, -1 outside the grid (csrc/voxelize.cu
    cell_of)."""
    v = vox.astype(np.int64)
    inside = np.all((v >= 0) & (v < r), axis=-1)
    return np.where(inside, (v[..., 0] * r + v[..., 1]) * r + v[..., 2], -1)


def _vox_order(cells, r3):
    """vox_order's walk for one item: integer counts, their exclusive scan,
    and the placement: 1024 points a round, whose warps take turns in
    order, which is the sequence of their 32-lane groups. A lane goes to its
    cell's cursor (read before its warp's leaders move it) plus its rank
    among the warp's earlier lanes of the same cell."""
    valid = cells[cells >= 0]
    offsets = np.zeros(r3 + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(valid, minlength=r3))
    cursor = offsets[:-1].copy()
    order = np.full(len(cells), -1, np.int64)
    for i0 in range(0, len(cells), 32):
        lanes = cells[i0:i0 + 32]
        at = cursor.copy()
        for lane, cell in enumerate(lanes):
            if cell >= 0:
                order[at[cell] + np.sum(lanes[:lane] == cell)] = i0 + lane
        for cell in np.unique(lanes[lanes >= 0]):
            cursor[cell] += np.sum(lanes == cell)
    return offsets, order[:offsets[-1]]


def _vox_mean(feats, offsets, order):
    """vox_mean: each cell's rows summed in the order's sequence in float32
    from 0, divided by the count; empty cells 0."""
    out = np.zeros((len(offsets) - 1, feats.shape[1]), np.float32)
    for cell in np.nonzero(np.diff(offsets))[0]:
        acc = np.zeros(feats.shape[1], np.float32)
        for j in order[offsets[cell]:offsets[cell + 1]]:
            acc = acc + feats[j]
        out[cell] = acc / np.float32(offsets[cell + 1] - offsets[cell])
    return out


def _ordered_reference(feats, cells, r3):
    """np.add.at applies in index order: the float32 sum in point order,
    then the division by the count."""
    keep = cells >= 0
    sums = np.zeros((r3, feats.shape[1]), np.float32)
    np.add.at(sums, cells[keep], feats[keep])
    count = np.bincount(cells[keep], minlength=r3).astype(np.float32)
    return np.where(count[:, None] > 0, sums / np.maximum(count, 1)[:, None],
                    np.float32(0))


def _vox_case(seed, n, r, c, edge):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3) * 0.3
    lo, hi = xyz.min(0), xyz.max(0)
    vox = np.round((xyz - lo) / (hi - lo) * (r - 1)).astype(np.int32)
    if edge == "one cell":
        vox[:] = vox[0]
    elif edge == "outside":
        vox[::7] = [r, 0, 0]
        vox[3] = [-1, 2, 1]
    feats = rng.randn(n, c).astype(np.float32)
    return vox, feats


@pytest.mark.parametrize("n,r,c,edge", [
    (700, 8, 3, None), (2048, 32, 64, None), (333, 5, 192, None),
    (100, 8, 8, "one cell"), (257, 16, 4, "outside"), (40, 32, 64, None)])
def test_cell_order_is_stable_and_the_means_are_ordered_sums(n, r, c, edge):
    vox, feats = _vox_case(n + r, n, r, c, edge)
    cells = _cells(vox, r)
    offsets, order = _vox_order(cells, r ** 3)
    # the stable order: cells ascending, points ascending within a cell
    keep = np.nonzero(cells >= 0)[0]
    np.testing.assert_array_equal(
        order, keep[np.argsort(cells[keep], kind="stable")])
    assert offsets[0] == 0 and offsets[-1] == len(keep)
    np.testing.assert_array_equal(
        np.diff(offsets), np.bincount(cells[keep], minlength=r ** 3))
    got = _vox_mean(feats, offsets, order)
    want = _ordered_reference(feats, cells, r ** 3)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # bf16 features: the same float32 sums, one rounding of the mean
    fb = torch.from_numpy(feats).to(BF16)
    got16 = torch.from_numpy(_vox_mean(fb.float().numpy(), offsets,
                                       order)).to(BF16)
    want16 = torch.from_numpy(_ordered_reference(fb.float().numpy(), cells,
                                                 r ** 3)).to(BF16)
    assert torch.equal(got16, want16)
    if edge != "outside":   # the plain version takes in-grid points only;
        # on the CPU its scatter_add runs in index order too
        plain = _avg_voxelize_plain(torch.from_numpy(feats)[None],
                                    torch.from_numpy(vox)[None], r)
        assert torch.equal(plain.reshape(r ** 3, c), torch.from_numpy(want))


@pytest.mark.parametrize("n,r,fits", [(2048, 32, True), (4096, 32, True),
                                      (2048, 36, True), (256, 40, False),
                                      (100000, 8, False), (40000, 32, False)])
def test_vox_order_shared_memory_plan(n, r, fits):
    """The counts and cells stay in shared memory up to 227 KB (every
    resolution of the port's configurations is at most 32), else in the
    global scratch; the plan mirrors the source's constants."""
    assert _constant("voxelize.cu", "kSmemMax") == SMEM_MAX
    smem = vox_order_smem(n, r)
    assert (smem > 0) == fits
    if fits:
        # the counts padded by a word after every 32 cells, then the cells
        assert smem == 4 * (r ** 3 + r ** 3 // 32 + 1 + n)
        assert smem + 128 <= SMEM_MAX


# ------------------------------------------------------------------ K7
# (B, N, M, K, widths): the bf16 local step's SA0-SA3, the style encoder's
# two SA blocks, and the GPU edge tests' shapes at batch 2
SA_MAIN = [(16, 2048, 1024, 32, (32, 64)), (16, 1024, 256, 32, (64, 128)),
           (16, 256, 64, 32, (128, 256)), (16, 64, 16, 32, (128, 128, 128)),
           (16, 2048, 1024, 32, (32, 32)), (16, 1024, 256, 32, (32, 64))]
SA_EDGE = [(2, n, m, k, w) for n, m, k, w in [
    (2048, 1024, 32, (32, 64)), (64, 16, 32, (128, 128, 128)),
    (300, 64, 8, (24,)), (500, 40, 8, (16, 40, 8)), (256, 128, 16, (64, 128)),
    (512, 64, 128, (32, 64)), (256, 32, 32, (256, 64)),
    (64, 8, 128, (256, 256, 256)), (20000, 8, 8, (8,))]]


@pytest.mark.parametrize("b,n,m,k,widths", SA_MAIN + SA_EDGE)
def test_sa_plan_tiles_the_centers_and_fits(b, n, m, k, widths):
    assert supports_sa_fused(m, k, widths)
    p = sa_plan(b, n, m, k, widths)
    assert p.tm * p.tiles == m and p.rows == p.tm * k
    assert p.rows % 16 == 0 and 64 <= p.rows <= 256
    assert p.rows in (64, 128)   # the kernel's 16-row warp tiles
    assert p.ld % 8 == 0 and p.ld >= max(widths)
    assert max(p.smem_query, p.smem_pass) <= SMEM_DYN
    # 16-byte rows, 32-byte fragment bases
    assert (p.rows * p.ld * 2) % 32 == 0
    # the weights stay for the pass when they fit in 24 KB
    stages = sum(-(-ci // 16) * 16 * LDW * 2 * -(-co // 64)
                 for ci, co in zip(widths[:-1], widths[1:]))
    assert p.resident == (stages <= 24576)
    # one wave: the blocks of every item are resident at once
    for smem, g, bound in ((p.smem_query, p.blocks_query, BLOCKS_SM_QUERY),
                            (p.smem_pass, p.blocks, BLOCKS_SM)):
        per_sm = min(bound, 233472 // (smem + 1024))
        assert 1 <= g <= p.tiles and b * g <= 132 * per_sm
        if b == 16 and k == 32 and max(widths) <= 128:   # the main path's
            assert per_sm == bound                       # SA0, SA1, SA3


def test_sa_plan_mirrors_the_source():
    src = "sa_fused.cu"
    assert _constant(src, "kThreads") == THREADS
    assert _constant(src, "kMaxLayers") == MAX_LAYERS
    assert _constant(src, "kRed") == RED
    assert _constant(src, "kChunk") + 8 == LDW
    assert _constant(src, "kSmemDyn") == SMEM_DYN
    assert _constant(src, "kResident") == 24576
    bounds = re.search(r"constexpr int kBlocksSm\[3\] = \{(\d+), (\d+), (\d+)\};",
                       (CSRC / src).read_text()).groups()
    assert tuple(map(int, bounds)) == (BLOCKS_SM_QUERY, BLOCKS_SM, BLOCKS_SM)
    assert not supports_sa_fused(16, 32, (32,) * (MAX_LAYERS + 1))


def _swish(v):
    return v / (1.0 + torch.exp(-v))


def _chan(acc, nb, mean_b, m2_b):
    n, mean, m2 = acc
    if nb == 0:
        return acc
    nn = n + nb
    d = mean_b - mean
    return nn, mean + d * nb / nn, m2 + m2_b + d * d * n * nb / nn


def _walk(args, blocks=None):
    """The kernel's passes in PyTorch, with its plan: indices once, then per
    layer a pass whose blocks walk their tiles and recompute the rows from
    the indices through the earlier layers; a block sums d = z - shift and
    d * d over its tiles' rows (the shift: the block's first row) into one
    partial (count, mean, centered M2); the partials merge by Chan's rule in
    the kernel's fixed tree, the GroupNorm and (ca, cb) fold into (sc, sh). The last
    pass recomputes through layer L and takes the max over K. Sums here are
    float64 where the kernel's threads sum in float32."""
    points, centers, a, bc, ws, bs, cas, cbs, radius, k = args
    b, n = points.shape[:2]
    m = centers.shape[1]
    widths = [ca.shape[-1] for ca in cas]
    plan = sa_plan(b, n, m, k, tuple(widths))
    idx = _ball_query_plain(centers, points, radius, k).long()
    sc, sh, seen = [], [], []

    def rows_of(bi, tile, layer):
        m0 = tile * plan.tm
        ids = idx[bi, m0:m0 + plan.tm].reshape(-1)
        z = (a[bi, ids] + bc[bi, m0:m0 + plan.tm].repeat_interleave(k, 0)
             ).to(BF16)
        for j in range(layer):
            h = _swish(z.float() * sc[j][bi] + sh[j][bi]).to(BF16)
            z = (h.float() @ ws[j].float() + bs[j]).to(BF16)
        return z

    for layer, c in enumerate(widths):
        g_n = blocks or (plan.blocks if layer else plan.blocks_query)
        s_l, h_l, rows_l = torch.empty(b, c), torch.empty(b, c), {}
        for bi in range(b):
            parts = []
            for g in range(g_n):
                zs = []
                for tile in range(g, plan.tiles, g_n):
                    rows_l[bi, tile] = rows_of(bi, tile, layer)
                    zs.append(rows_l[bi, tile].double())
                d = torch.cat(zs) - zs[0][0]
                nb, s1, s2 = len(d), d.sum(0), (d * d).sum(0)
                parts.append((nb, zs[0][0] + s1 / nb, s2 - s1 * s1 / nb))
            # the last block's fixed tree: strided slices of blocks, then
            # the slices in order
            zero = (0.0, torch.zeros(c, dtype=torch.float64),
                    torch.zeros(c, dtype=torch.float64))
            merged = zero
            for sl in range(THREADS // c):
                acc = zero
                for part in parts[sl::THREADS // c]:
                    acc = _chan(acc, *part)
                merged = _chan(merged, *acc)
            mean, m2 = merged[1].numpy(), merged[2].numpy()
            cg = c // GN_GROUPS
            nc = float(m * k)
            for ch in range(c):
                g0 = ch // cg * cg
                mg = mean[g0:g0 + cg].mean()
                m2g = (m2[g0:g0 + cg] + nc * (mean[g0:g0 + cg] - mg) ** 2
                       ).sum()
                rs = np.float32(1.0 / np.sqrt(m2g / (nc * cg) + GN_EPS))
                s_l[bi, ch] = float(rs * np.float32(cas[layer][bi, ch]))
                h_l[bi, ch] = float(np.float32(cbs[layer][bi, ch])
                                    - np.float32(mg) * np.float32(s_l[bi, ch]))
        sc.append(s_l)
        sh.append(h_l)
        seen.append(rows_l)
    out = torch.empty(b, m, widths[-1], dtype=BF16)
    for bi in range(b):
        for tile in range(plan.tiles):
            z = rows_of(bi, tile, len(widths) - 1)
            # the invariant: the last pass recomputes the very rows whose
            # statistics the previous pass took
            assert torch.equal(z, seen[-1][bi, tile])
            h = _swish(z.float() * sc[-1][bi] + sh[-1][bi]).to(BF16)
            m0 = tile * plan.tm
            out[bi, m0:m0 + plan.tm] = h.reshape(plan.tm, k, -1).amax(1)
    return out


def _sa_args(seed, b, n, m, k, widths, radius):
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32) * 0.3
    ctr = pts[:, :m].copy()
    ctr[:, 0] = 5.0                              # an empty ball
    c0 = 6
    feats = rng.randn(b, n, c0).astype(np.float32)
    w1 = rng.randn(3 + c0, widths[0]).astype(np.float32) * 0.3
    b1 = rng.randn(widths[0]).astype(np.float32) * 0.1
    a = np.concatenate([pts, feats], -1) @ w1 + b1
    bc = -(ctr @ w1[:3])
    ws = [torch.from_numpy(rng.randn(ci, co).astype(np.float32)
                           * ci ** -0.5).to(BF16)
          for ci, co in zip(widths[:-1], widths[1:])]
    bs = [torch.from_numpy(rng.randn(co).astype(np.float32) * 0.1)
          for co in widths[1:]]
    cas = [torch.from_numpy(1.0 + 0.2 * rng.randn(b, co).astype(np.float32))
           for co in widths]
    cbs = [torch.from_numpy(0.2 * rng.randn(b, co).astype(np.float32))
           for co in widths]
    t = torch.from_numpy
    return (t(pts), t(ctr), t(a.astype(np.float32)),
            t(bc.astype(np.float32)), ws, bs, cas, cbs, radius, k)


def _bf16_close(got, ref, rel):
    """The card's gate (chip_smoke.py _bf16_close): statistics summed in
    another order move a few bf16 roundings by one ulp."""
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(got.float(), ref.float(), rtol=rel,
                               atol=rel * scale)


@pytest.mark.parametrize("b,n,m,k,widths,radius,blocks", [
    (2, 128, 32, 32, (32, 64), 0.3, None),     # SA0's K and widths
    (2, 128, 32, 32, (32, 64), 0.3, 3),        # blocks walk several tiles
    (1, 64, 16, 32, (16, 24, 16), 0.5, 1),     # three layers, one block
    (2, 96, 16, 8, (24,), 0.05, None)])        # one layer, sparse balls
def test_walk_matches_the_plain_version(b, n, m, k, widths, radius, blocks):
    args = _sa_args(11, b, n, m, k, widths, radius)
    got = _walk(args, blocks)
    want = _sa_fused_plain(*args)
    assert got.dtype == BF16 and got.shape == (b, m, widths[-1])
    _bf16_close(got, want, 2e-2)


def test_walk_matches_the_pallas_kernel():
    """SA0's K (32) and widths (32, 64) at a small N and M against
    pointnet_sa_fused_pallas in interpret mode, with the bounds of
    test_sa_fused_plain_matches_the_pallas_kernel (tests/
    test_torch_port_bf16.py): both run GroupNorm on bf16 rows, and
    near-degenerate groups amplify bf16 noise by 1/sigma, so a tight bulk
    (99% of |diff| < 5e-2) and a loose tail (max < 0.5)."""
    from lion_tpu.ops.pallas.sa_fused import pointnet_sa_fused_pallas
    args = _sa_args(5, 2, 128, 32, 32, (32, 64), 0.3)
    points, centers, a, bc, ws, bs, cas, cbs, radius, k = args
    j = lambda x: jnp.asarray(x.float().numpy())  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = pointnet_sa_fused_pallas(
            j(points), j(centers), j(a.transpose(1, 2)),
            j(bc.transpose(1, 2)),
            tuple(j(w.float().T).astype(jnp.bfloat16) for w in ws),
            tuple(j(bl[:, None]) for bl in bs), tuple(map(j, cas)),
            tuple(map(j, cbs)), radius, k)
    want = np.transpose(np.asarray(jnp.asarray(want, jnp.float32)), (0, 2, 1))
    got = _walk(args, 3).float().numpy()
    err = np.abs(got - want)
    assert np.quantile(err, 0.99) < 5e-2, np.quantile(err, 0.99)
    assert err.max() < 0.5, err.max()
