"""The channel-first ball query + grouping (K13's plain version and its
backward) against lion_tpu.ops.points.ball_query_group_cf on the CPU.

On the CPU the JAX op runs its XLA form (the row-layout gather transposed
(0, 2, 3, 1)); the channel-first Pallas kernel has no interpret switch.
Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.ops.points import ball_query_group_cf as j_bqg_cf

from lion_tpu_torch import ops

from test_torch_port_sample import one_torch_thread  # noqa: F401


def _inputs(seed, b, n, m, c):
    rs = np.random.RandomState(seed)
    pts = (rs.randn(b, n, 3) * 0.3).astype(np.float32)
    ctr = pts[:, :m].copy()
    ctr[:, 0] = 5.0                                   # an empty ball
    ctr[:, 1] += 0.01
    feats = rs.randn(b, n, c).astype(np.float32)
    return pts, ctr, feats


# (n, m, k, c, radius): partial balls, K above the hit count, K = N with
# every point in the ball (the JAX form's top-k takes no K above N), M not
# a multiple of the kernel's 32-center tile, one feature channel
CASES = [(64, 16, 8, 5, 0.3), (128, 37, 32, 16, 0.2), (50, 20, 50, 3, 2.0),
         (256, 64, 16, 1, 0.15)]


@pytest.mark.parametrize("n,m,k,c,r", CASES)
def test_ball_query_group_cf_forward_matches_jax(n, m, k, c, r):
    """fp32: exact (the same indices, the same fp32 subtraction)."""
    pts, ctr, feats = _inputs(1, 2, n, m, c)
    want = np.asarray(j_bqg_cf(jnp.asarray(pts), jnp.asarray(ctr),
                               jnp.asarray(feats), r, k))
    got = ops.ball_query_group_cf(torch.from_numpy(pts), torch.from_numpy(ctr),
                                  torch.from_numpy(feats), r, k)
    assert got.shape == (2, k, 3 + c, m) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the empty ball takes point 0 in every slot
    np.testing.assert_array_equal(got[:, :, 3:, 0].numpy(),
                                  np.repeat(feats[:, None, 0], k, axis=1))


def test_ball_query_group_cf_bf16_matches_jax():
    """bf16 features: the output takes their dtype; the coordinates are
    subtracted in fp32 and rounded once, as the XLA form casts them."""
    pts, ctr, feats = _inputs(2, 2, 128, 40, 8)
    fb = jnp.asarray(feats).astype(jnp.bfloat16)
    want = j_bqg_cf(jnp.asarray(pts), jnp.asarray(ctr), fb, 0.25, 16)
    got = ops.ball_query_group_cf(
        torch.from_numpy(pts), torch.from_numpy(ctr),
        torch.from_numpy(feats).to(torch.bfloat16), 0.25, 16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_ball_query_group_cf_is_the_row_layout_permuted():
    pts, ctr, feats = map(torch.from_numpy, _inputs(3, 2, 96, 24, 6))
    cf = ops.ball_query_group_cf(pts, ctr, feats, 0.3, 8)
    rows = ops.ball_query_group(pts, ctr, feats, 0.3, 8)
    assert torch.equal(cf, rows.permute(0, 2, 3, 1))


@pytest.mark.parametrize("n,m,k,c,r", CASES[:2])
def test_ball_query_group_cf_backward_matches_jax(n, m, k, c, r):
    """Gradients to points, centers and features against jax.vjp of the
    JAX op (its backward replays the XLA form)."""
    pts, ctr, feats = _inputs(4, 2, n, m, c)
    g = np.random.RandomState(5).randn(2, k, 3 + c, m).astype(np.float32)
    _, vjp = jax.vjp(lambda p, q, f: j_bqg_cf(p, q, f, r, k),
                     jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(feats))
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (pts, ctr, feats)]
    ops.ball_query_group_cf(*xs, r, k).backward(torch.from_numpy(g))
    for x, w in zip(xs, want):
        # scatter-adds of up to K * M terms in another order
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_ball_query_group_cf_needs_features():
    pts, ctr, _ = map(torch.from_numpy, _inputs(6, 1, 32, 8, 2))
    with pytest.raises(ValueError, match="requires features"):
        ops.ball_query_group_cf(pts, ctr, None, 0.3, 4)
