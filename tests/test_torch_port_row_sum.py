"""The ordered row sum of the training backwards (csrc/row_sum.cu) on the
CPU: a numpy walk of its two launches against its plain version (a
float32 `scatter_add_`), bit for bit; its plan mirrored from the sources;
`scatter_rows` and `gather_rows`, each the other's gradient, through a
second derivative; and the point ops' backwards (K2, K13, K5, K6, and K3
under a second derivative) summing through it.

The kernel runs only on the card (tests/test_torch_port_gpu.py). On the
CPU its plain version adds the rows in ascending r; the kernel's order is
the same, so the two agree bit for bit.
"""
import numpy as np
import pytest
import torch

from lion_tpu_torch import ops
from lion_tpu_torch.ops import rows as rows_mod
from lion_tpu_torch.ops import voxel

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_walks import _constant, _vox_order

BF16 = torch.bfloat16


def _row_sum_walk(idx, rows, n):
    """The kernel's two launches for one item: the stable order of the
    indices (K3's placement, `_vox_order`: integer counts, their scan, each
    warp's lanes placed by rank among its earlier lanes of the same key),
    then each output row's rows summed in that order in float32 from 0 and
    stored once (0 for a row no index names)."""
    offsets, order = _vox_order(idx.astype(np.int64), n)
    out = np.zeros((n, rows.shape[1]), np.float32)
    for k in np.nonzero(np.diff(offsets))[0]:
        acc = np.zeros(rows.shape[1], np.float32)
        for j in order[offsets[k]:offsets[k + 1]]:
            acc = acc + rows[j]
        out[k] = acc
    return out


@pytest.mark.parametrize("b,r,n,c,dt,kind", [
    (2, 3000, 37, 5, torch.float32, "uniform"),
    (2, 4096, 256, 35, torch.float32, "uniform"),   # K2's backward, small
    (2, 4096, 256, 35, BF16, "uniform"),             # on a bf16 gradient
    (1, 2000, 5000, 8, torch.float32, "uniform"),    # mostly empty rows
    (2, 2500, 3, 4, torch.float32, "crowded"),       # a few crowded rows
    (2, 1500, 64, 3, torch.float32, "one row"),      # every row into one
    (1, 0, 9, 4, torch.float32, "uniform")])         # no rows: zeros
def test_row_sum_walk_equals_scatter_add(b, r, n, c, dt, kind):
    rng = np.random.RandomState(r + n + c)
    if kind == "one row":
        idx = np.full((b, r), n // 2, np.int32)
    else:
        idx = rng.randint(0, n, (b, r)).astype(np.int32)
    # magnitudes over many decades: the order of a float32 sum shows
    rows = (rng.randn(b, r, c) * np.exp(rng.randn(b, r, 1) * 3)).astype(
        np.float32)
    rows_t = torch.from_numpy(rows).to(dt)
    plain = ops.KERNELS["row_sum"].plain(torch.from_numpy(idx), rows_t, n)
    assert plain.dtype == torch.float32 and plain.shape == (b, n, c)
    for i in range(b):
        got = _row_sum_walk(idx[i], rows_t[i].float().numpy(), n)
        assert np.array_equal(got.view(np.int32),
                              plain[i].numpy().view(np.int32))


@pytest.mark.parametrize("r,n,fits", [(32768, 2048, True),
                                      (16384, 32768, True),
                                      (6144, 1024, True),
                                      (1000, 70000, False),
                                      (60000, 2048, False)])
def test_row_order_shared_memory_plan(r, n, fits):
    """The stable order's counts and keys stay in shared memory up to
    227 KB (every backward of the flagship's training steps at its batch),
    else in a global scratch; the plan mirrors the sources' constants."""
    assert _constant("row_sum.cu", "kSmemMax") == rows_mod.SMEM_MAX
    assert _constant("stable_order.cuh", "kOrderThreads") \
        == rows_mod.ORDER_THREADS
    smem = rows_mod.order_smem(r, n)
    assert (smem > 0) == fits
    if fits:
        assert smem == 4 * (n + n // 32 + 1 + r)
        assert smem + 4 * rows_mod.ORDER_THREADS // 32 <= rows_mod.SMEM_MAX
    # K3 orders its points with the same code and plan
    assert voxel.vox_order_smem(2048, 32) == rows_mod.order_smem(2048,
                                                                 32 ** 3)


def test_scatter_and_gather_rows_are_each_others_gradient():
    """First and second derivatives through both, against the same graph
    built from torch.gather and scatter_add: equal bit for bit."""
    rng = np.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(2, 40, 6).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40, (2, 300)))
    v = torch.from_numpy(rng.randn(2, 300, 6).astype(np.float32))

    def gather_ref(x, i):
        return torch.gather(x, 1, i[:, :, None].expand(-1, -1, x.shape[-1]))

    def scatter_ref(i, rows, n):
        return torch.zeros(rows.shape[0], n, rows.shape[-1]).scatter_add(
            1, i[:, :, None].expand(-1, -1, rows.shape[-1]), rows)

    def run(gather, scatter):
        x = x0.clone().requires_grad_(True)
        y = gather(torch.tanh(x), idx)
        (gx,) = torch.autograd.grad((y * v).sum(), x, create_graph=True)
        s = scatter(idx, y * y, 40)
        loss = (gx * gx).sum() + (s * torch.cos(s)).sum()
        return (y, gx, s) + torch.autograd.grad(loss, x)
    for a, b in zip(run(ops.gather_rows, ops.scatter_rows),
                    run(gather_ref, scatter_ref)):
        assert torch.equal(a.detach(), b.detach())


def test_scatter_rows_returns_float32_and_gathers_back_in_the_rows_dtype():
    rows = torch.randn(2, 50, 8).to(BF16).requires_grad_(True)
    idx = torch.randint(0, 10, (2, 50))
    out = ops.scatter_rows(idx, rows, 10)
    assert out.dtype == torch.float32
    (g,) = torch.autograd.grad(out.sum() * 2.0, rows)
    assert g.dtype == BF16 and torch.equal(g, torch.full_like(g, 2.0))


def test_point_op_backwards_sum_through_the_row_sum():
    """K2's (and so K13's), K5's and K6's backwards call the row sum (its
    plain version here) once each; K3's backward gathers, and its second
    derivative sums through the row sum."""
    rng = np.random.RandomState(4)
    pts = torch.from_numpy(rng.randn(2, 128, 3).astype(np.float32) * 0.3)
    ctr = pts[:, :16].clone()
    feats = torch.from_numpy(rng.randn(2, 128, 8).astype(np.float32))
    w = ops.KERNELS["row_sum"]

    def calls(fn, *inputs):
        xs = [t.clone().requires_grad_(True) for t in inputs]
        before = w.plain_calls
        out = fn(*xs)
        torch.autograd.grad(out, xs, torch.randn_like(out))
        return w.plain_calls - before
    assert calls(lambda p, c, f: ops.ball_query_group(p, c, f, 0.3, 8),
                 pts, ctr, feats) == 1
    assert calls(lambda p, c, f: ops.ball_query_group_cf(p, c, f, 0.3, 8),
                 pts, ctr, feats) == 1
    nc = voxel.normalize_coords(pts, 8).contiguous()
    grid = torch.from_numpy(rng.randn(2, 8, 8, 8, 8).astype(np.float32))
    assert calls(lambda g: ops.trilinear_devoxelize(g, nc, 8), grid) == 1
    assert calls(lambda f: ops.nearest_neighbor_interpolate(pts, ctr, f),
                 feats[:, :16]) == 1
    # K3: the backward gathers g / count; its second derivative (a
    # gradient of the gradient) sums rows into the cells
    vox = torch.round(nc).to(torch.int32)
    f = feats.clone().requires_grad_(True)
    g = torch.randn(2, 8, 8, 8, 8, requires_grad=True)
    (gf,) = torch.autograd.grad(ops.avg_voxelize(f, vox, 8), f, g,
                                create_graph=True)
    before = w.plain_calls
    (gg,) = torch.autograd.grad((gf * gf).sum(), g)
    assert w.plain_calls - before == 1 and torch.isfinite(gg).all()


def test_k2_backward_sums_the_coordinates_and_features_in_one_row_sum():
    """The points' and the features' gradients come from one row sum of the
    whole rows: equal to two separate scatter-adds, bit for bit."""
    rng = np.random.RandomState(5)
    pts = torch.from_numpy(rng.randn(2, 200, 3).astype(np.float32) * 0.3)
    ctr = pts[:, :20].clone()
    feats = torch.from_numpy(rng.randn(2, 200, 6).astype(np.float32))
    xs = [t.clone().requires_grad_(True) for t in (pts, ctr, feats)]
    out = ops.ball_query_group(*xs, 0.3, 16)
    g = torch.randn_like(out)
    gp, gc, gf = torch.autograd.grad(out, xs, g)
    idx = ops.ball_query(ctr, pts, 0.3, 16).reshape(2, -1).long()
    flat = g.reshape(2, -1, 9)
    want_p = torch.zeros(2, 200, 3).scatter_add_(
        1, idx[:, :, None].expand(-1, -1, 3), flat[..., :3])
    want_f = torch.zeros(2, 200, 6).scatter_add_(
        1, idx[:, :, None].expand(-1, -1, 6), flat[..., 3:])
    assert torch.equal(gp, want_p) and torch.equal(gf, want_f)
    assert torch.equal(gc, -g[..., :3].sum(dim=2))


def test_k10_weight_gradient_runs_on_deterministic_cudnn(monkeypatch):
    """K10's weight gradient on the CPU takes the wrapper's plain version,
    `torch.nn.grad.conv3d_weight` in float32, once per backward, and equals
    it; on the card the same wrapper launches the port's fixed-order kernel
    (csrc/conv3d_wgrad.cu), which repeats bit for bit without cuDNN's
    deterministic algorithms (tests/test_torch_port_gpu.py)."""
    seen = []
    wgrad = torch.nn.grad.conv3d_weight

    def spy(*args, **kwargs):
        seen.append(args[0].dtype)
        return wgrad(*args, **kwargs)
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight", spy)
    k = ops.KERNELS["conv3d_weight_grad"]
    before = k.plain_calls
    x = torch.randn(1, 4, 4, 4, 3, requires_grad=True)
    w = torch.randn(3, 3, 3, 3, 5, requires_grad=True)
    g = torch.randn(1, 4, 4, 4, 5)
    ops.conv3d_3x3_same(x, w).backward(g)
    assert seen == [torch.float32] and k.plain_calls - before == 1
    want = wgrad(x.detach().permute(0, 4, 1, 2, 3), (5, 3, 3, 3, 3),
                 g.permute(0, 4, 1, 2, 3), padding=1).permute(2, 3, 4, 1, 0)
    assert torch.equal(w.grad, want)
