"""The port's evaluation slice against the JAX package on the CPU: the
approximate EMD (K12's plain version, the differentiable form and its
gradient), chamfer, the pairwise metric matrices with block padding, MMD /
COV / 1-NNA, JSD, `compute_score` on .pt files, and the DDIM sampler.

Inputs come from numpy seeds; both packages get the same arrays. Where the
JAX function reaches a Pallas kernel it runs in interpret mode; elsewhere
the JAX package's CPU path is its XLA form, which the port's plain versions
follow.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.diffusion.discrete import DiffusionDiscretized as JaxDD
from lion_tpu.eval import eval_helper as jeh
from lion_tpu.eval import metrics as jm
from lion_tpu.models.priors import GlobalPrior as JGlobalPrior
from lion_tpu.models.priors import LocalPrior as JLocalPrior
from lion_tpu.ops.chamfer import chamfer as j_chamfer
from lion_tpu.ops.chamfer import chamfer_dist as j_chamfer_dist
from lion_tpu.ops.chamfer import chamfer_l1 as j_chamfer_l1
from lion_tpu.ops import emd as jemd
from lion_tpu.ops.pallas.emd import emd_approx_pallas

from lion_tpu_torch import ops
from lion_tpu_torch.ckpt import state_dict_from_jax
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.diffusion import DiffusionDiscretized
from lion_tpu_torch.eval import eval_helper as eh
from lion_tpu_torch.eval import metrics as tm
from lion_tpu_torch.models import LION
from lion_tpu_torch.models.priors import GlobalPrior, LocalPrior
from lion_tpu_torch.nn import init_weights

from test_torch_port_sample import (  # noqa: F401
    one_torch_thread, tiny_cfg, to_jax_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
# the JAX package's own gate between its EMD kernel and its XLA form
# (tests/test_ops.py:291): the auction's exp(level * d2) at |level| up to
# 16384 amplifies fp32 rounding of d2 and of the sums
EMD_RTOL, EMD_ATOL = 2e-3, 1e-5


def clouds(seed, *shape, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pairs(s, r):
    i, j = np.meshgrid(np.arange(s), np.arange(r), indexing="ij")
    return torch.from_numpy(np.stack([i.ravel(), j.ravel()], 1).astype(
        np.int32))


# ------------------------------------------------------------------ EMD
@pytest.mark.parametrize("n,m", [(64, 64), (64, 128), (128, 64)])
def test_emd_plain_matches_jax(n, m):
    """K12's plain version and the differentiable form against
    lion_tpu.ops.emd.emd_approx, N = M and N != M both ways."""
    a, b = clouds(1, 3, n, 3), clouds(2, 3, m, 3)
    want = np.asarray(jemd.emd_approx(jnp.asarray(a), jnp.asarray(b)))
    pairs = torch.tensor([[0, 0], [1, 1], [2, 2]], dtype=torch.int32)
    got = ops.emd_cost(torch.from_numpy(a), torch.from_numpy(b), pairs)
    np.testing.assert_allclose(got.numpy(), want, rtol=EMD_RTOL,
                               atol=EMD_ATOL)
    diff = ops.emd_approx(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(diff.numpy(), want, rtol=EMD_RTOL,
                               atol=EMD_ATOL)


def test_emd_plain_matches_pallas_interpret():
    """At N = M = 128 (lane-aligned) against the TPU kernel in interpret
    mode, on every (sample, ref) pair of 3 x 2 clouds; and a permuted copy
    costs ~0."""
    a, b = clouds(3, 3, 128, 3, scale=0.4), clouds(4, 2, 128, 3, scale=0.4)
    pairs = _pairs(3, 2)
    got = ops.emd_cost(torch.from_numpy(a), torch.from_numpy(b), pairs)
    idx = pairs.numpy()
    want = np.asarray(emd_approx_pallas(jnp.asarray(a[idx[:, 0]]),
                                        jnp.asarray(b[idx[:, 1]]),
                                        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=EMD_RTOL,
                               atol=EMD_ATOL)
    perm = np.random.RandomState(9).permutation(128)
    own = ops.emd_cost(torch.from_numpy(a[:1]),
                       torch.from_numpy(a[:1, perm].copy()),
                       torch.zeros((1, 2), dtype=torch.int32))
    assert float(own[0]) < 1e-3


def test_emd_plain_repeated_and_unordered_pairs():
    """Pairs in any order, repeated, give each pair's own cost."""
    a, b = clouds(5, 2, 48, 3), clouds(6, 3, 48, 3)
    pairs = torch.tensor([[1, 2], [0, 0], [1, 2], [0, 1]], dtype=torch.int32)
    got = ops.emd_cost(torch.from_numpy(a), torch.from_numpy(b), pairs)
    assert got[0] == got[2]
    for p, (i, j) in enumerate(pairs.tolist()):
        one = ops.emd_approx(torch.from_numpy(a[i:i + 1]),
                             torch.from_numpy(b[j:j + 1]))
        # alone or in a batch: batched products sum in another order
        torch.testing.assert_close(got[p:p + 1], one, rtol=1e-6, atol=0)


def test_emd_approx_gradient_matches_jax():
    """The match is detached; the gradient flows through d2 alone."""
    a, b = clouds(7, 2, 64, 3), clouds(8, 2, 64, 3)
    g = clouds(9, 2, scale=1.0)
    _, vjp = jax.vjp(jemd.emd_approx, jnp.asarray(a), jnp.asarray(b))
    want_a, want_b = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ops.emd_approx(ta, tb).backward(torch.from_numpy(g))
    # the match enters as a constant: its rounding moves the gradient by
    # about as much as the cost
    for got, want in ((ta.grad, want_a), (tb.grad, want_b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=EMD_RTOL, atol=EMD_ATOL)


def test_emd_cost_refuses_bad_devices():
    a = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="no kernel"):
        ops.emd_cost(a.to("meta"), a.to("meta"),
                     torch.zeros((1, 2), dtype=torch.int32, device="meta"))


# ------------------------------------------------------------------ chamfer
def test_chamfer_matches_jax():
    """fp32 distances within 1e-6, argmin indices exactly."""
    a, b = clouds(10, 2, 64, 3), clouds(11, 2, 80, 3)
    want = j_chamfer(jnp.asarray(a), jnp.asarray(b))
    got = ops.chamfer(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ops.chamfer_dist(torch.from_numpy(a),
                                     torch.from_numpy(b)),
                    j_chamfer_dist(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_chamfer_l1_matches_jax():
    """Nearest neighbours over xyz, L1 over all four coords."""
    a, b = clouds(12, 2, 64, 4), clouds(13, 2, 48, 4)
    want = j_chamfer_l1(jnp.asarray(a), jnp.asarray(b))
    got = ops.chamfer_l1(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        # sums of 64 * 4 fp32 terms in another order
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


# ------------------------------------------------------------------ metrics
def test_pairwise_cd_matches_jax_with_padding():
    """6 samples x 5 refs: the port's blocks (8, 32) and smaller ones
    (4, 3) both pad with cloud 0 and crop."""
    s, r = clouds(14, 6, 48, 3), clouds(15, 5, 48, 3)
    want = jm.pairwise_cd(s, r)
    for bs, br in ((8, 32), (4, 3)):
        got = tm.pairwise_cd(s, r, bs, br, device=CPU)
        assert got.shape == (6, 5)
        # means of fp32 minima; the matmul form's rounding
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_pairwise_emd_matches_jax_with_padding():
    s, r = clouds(16, 6, 48, 3), clouds(17, 5, 48, 3)
    want = jm.pairwise_emd(s, r)
    for bs, br in (tm.EMD_BLOCK, (4, 3)):
        got = tm.pairwise_emd(s, r, bs, br, device=CPU)
        assert got.shape == (6, 5)
        np.testing.assert_allclose(got, want, rtol=EMD_RTOL, atol=EMD_ATOL)


def test_lgan_mmd_cov_and_knn_are_exact():
    rs = np.random.RandomState(18)
    m_rs, m_rr, m_ss = (rs.rand(7, 9).astype(np.float32),
                        rs.rand(7, 7).astype(np.float32),
                        rs.rand(9, 9).astype(np.float32))
    assert tm.lgan_mmd_cov(m_rs.T) == jm.lgan_mmd_cov(m_rs.T)
    for k in (1, 3):
        assert tm.knn_accuracy(m_rr, m_rs, m_ss, k=k) == \
            jm.knn_accuracy(m_rr, m_rs, m_ss, k=k)
    assert tm.knn_accuracy(m_rr, m_rs, m_ss, sqrt=True) == \
        jm.knn_accuracy(m_rr, m_rs, m_ss, sqrt=True)


def test_compute_all_metrics_matches_jax():
    s, r = clouds(19, 7, 64, 3, scale=0.2), clouds(20, 6, 64, 3, scale=0.2)
    want = jm.compute_all_metrics(s, r)
    got = tm.compute_all_metrics(s, r, device=CPU)
    assert got.keys() == want.keys()
    for k in want:
        # MMD: CD and EMD means (EMD at its gate); COV / 1-NNA are counts
        # over argmins, equal unless two entries sit within that tolerance
        np.testing.assert_allclose(got[k], want[k], rtol=EMD_RTOL,
                                   atol=EMD_ATOL, err_msg=k)


def test_jsd_matches_jax():
    """The clipped-sphere occupancy counts are the same, so the JSD is."""
    s, r = clouds(21, 5, 256, 3, scale=0.2), clouds(22, 4, 256, 3, scale=0.15)
    for a in (s, r):
        _, want = jm.entropy_of_occupancy_grid(a, 28, True)
        _, got = tm.entropy_of_occupancy_grid(a, 28, True, device=CPU)
        np.testing.assert_array_equal(got, want)
    want = jm.jsd_between_point_cloud_sets(s, r)
    got = tm.jsd_between_point_cloud_sets(s, r, device=CPU)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)
    # the full (unclipped) grid rounds to the cell directly
    e_got, c_got = tm.entropy_of_occupancy_grid(s, 8, False, device=CPU)
    e_want, c_want = jm.entropy_of_occupancy_grid(s, 8, False)
    np.testing.assert_array_equal(c_got, c_want)
    assert e_got == pytest.approx(e_want, rel=1e-12)


def test_emd_cd_paired_and_nll_metric_match_jax():
    s, r = clouds(23, 5, 64, 3), clouds(24, 5, 64, 3)
    want = jm.emd_cd_paired(s, r, batch_size=2, reduced=False)
    got = tm.emd_cd_paired(s, r, batch_size=2, reduced=False, device=CPU)
    np.testing.assert_allclose(got["MMD-CD"], want["MMD-CD"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["MMD-EMD"], want["MMD-EMD"],
                               rtol=EMD_RTOL, atol=EMD_ATOL)
    got = eh.compute_nll_metric(s, r, batch_size=2, device=CPU)
    want = jeh.compute_nll_metric(s, r, batch_size=2)
    assert got.keys() == want.keys()
    assert got["MMD-EMD"] == pytest.approx(want["MMD-EMD"], rel=EMD_RTOL)


def test_registry_and_normalization_match_jax():
    for cats in ("airplane", "chair_ps", "car"):
        assert eh.get_cats(cats) == jeh.get_cats(cats)
        assert eh.get_ref_pt(cats) == jeh.get_ref_pt(cats)
        assert eh.get_ref_num(eh.get_cats(cats), True) == \
            jeh.get_ref_num(jeh.get_cats(cats), True)
    pcs = clouds(25, 3, 40, 6) * 3.0 + 1.0
    np.testing.assert_array_equal(eh.normalize_point_clouds(pcs),
                                  jeh.normalize_point_clouds(pcs))


def _score_files(tmp_path, n_ref=6, n_ref_pts=48, n_gen_pts=64):
    """A reference .pt ({"ref", "mean", "std"}) and a sample .pt with more
    points than the refs, so compute_score draws a permutation."""
    rs = np.random.RandomState(30)
    ref = rs.randn(n_ref, n_ref_pts, 3).astype(np.float32) * 0.2
    mean = rs.randn(n_ref, 1, 3).astype(np.float32) * 0.1
    std = np.abs(rs.randn(n_ref, 1, 1).astype(np.float32)) + 0.5
    gen = rs.randn(n_ref + 1, n_gen_pts, 3).astype(np.float32) * 0.2
    ref_path, gen_path = str(tmp_path / "ref.pt"), str(tmp_path / "gen.pt")
    torch.save({"ref": torch.from_numpy(ref), "mean": torch.from_numpy(mean),
                "std": torch.from_numpy(std)}, ref_path)
    torch.save(torch.from_numpy(gen), gen_path)
    return gen_path, ref_path


@pytest.mark.parametrize("norm_box", [False, True])
def test_compute_score_matches_jax(tmp_path, norm_box):
    """The same keys and values, and the same TSV line byte for byte."""
    gen_path, ref_path = _score_files(tmp_path)
    np.random.seed(3)
    want = jeh.compute_score(gen_path, ref_path, norm_box=norm_box,
                             dataset="test", results_dir=str(tmp_path / "j"))
    got = eh.compute_score(gen_path, ref_path, norm_box=norm_box,
                           dataset="test", results_dir=str(tmp_path / "t"),
                           device=CPU, rng=np.random.RandomState(3))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EMD_RTOL,
                                   atol=EMD_ATOL, err_msg=k)
    tsv = [(tmp_path / d / "eval_out.csv").read_bytes() for d in ("j", "t")]
    assert tsv[0] == tsv[1] and b"1-NNA-CD" in tsv[1]


def test_compute_score_cli(tmp_path):
    gen_path, ref_path = _score_files(tmp_path, n_ref=3, n_gen_pts=48)
    res = subprocess.run(
        [sys.executable, "-m", "lion_tpu_torch.eval.compute_score", gen_path,
         ref_path, "--device", "cpu", "--dataset", "cli"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "lgan_mmd-EMD:" in res.stdout and "jsd:" in res.stdout
    assert (tmp_path / "results" / "eval_out.csv").read_text().startswith(
        "Dataset")


def test_scoring_defaults_to_the_card():
    s = clouds(26, 2, 16, 3)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default runs on the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.pairwise_emd(s, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.jsd_between_point_cloud_sets(s, s)


def test_eval_imports_no_jax():
    code = ("import sys, lion_tpu_torch.eval, "
            "lion_tpu_torch.eval.compute_score;"
            "bad = [m for m in ('jax', 'flax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------------ DDIM
@pytest.mark.parametrize("skip", ["uniform", "quad"])
@pytest.mark.parametrize("steps", [2, 10, 50, 200])
def test_ddim_tau_schedule_matches_jax(skip, steps):
    mine = DiffusionDiscretized(get_default_cfg())
    ref = JaxDD(jax_default_cfg())
    assert mine.ddim_tau_schedule(steps, skip) == \
        ref.ddim_tau_schedule(steps, skip)


@pytest.mark.parametrize("skip", ["uniform", "quad"])
def test_ddim_constants_kappa_one(skip):
    """alpha_next and sigma as lion_tpu's run_ddim builds them
    (lion_tpu/diffusion/discrete.py:203-219)."""
    ref = JaxDD(jax_default_cfg())
    taus = ref.ddim_tau_schedule(25, skip)
    ab = np.asarray(ref.alpha_bars)
    a_next = [ab[t] for t in taus[1:]] + [1.0]
    sigma = [np.sqrt((1 - an) / (1 - ab[t]) * (1 - ab[t] / an))
             for t, an in zip(taus[:-1], a_next[:-1])] + [0.0]
    got = DiffusionDiscretized(get_default_cfg()).ddim_constants(25, skip,
                                                                 1.0)
    assert got[0] == taus
    np.testing.assert_array_equal(got[1], np.asarray(a_next, np.float32))
    np.testing.assert_array_equal(got[2], np.asarray(sigma, np.float32))
    assert got[2][:-1].min() > 0


@pytest.mark.parametrize("mixed", [False, True])
def test_run_ddim_matches_jax_through_the_global_prior(mixed):
    """kappa 0 (no noise after the first draw) and the same x_noisy through
    a tiny global prior, 20 DDIM steps over the 1000-step schedule."""
    style, b, steps = 128, 3, 20
    x0 = clouds(27, b, style, scale=1.0)
    jp = JGlobalPrior(style, nf=64, num_blocks=2, embedding_dim=16,
                      mixed_prediction=mixed)
    params = jax.jit(jp.init)(jax.random.PRNGKey(5), jnp.asarray(x0),
                              jnp.ones((b,)))
    m = GlobalPrior(style, nf=64, num_blocks=2, embedding_dim=16,
                    mixed_prediction=mixed)
    m.load_state_dict(state_dict_from_jax(jax.device_get(params["params"])),
                      strict=True)
    m.eval()
    logit = params["params"].get("mixing_logit") if mixed else None
    want = JaxDD(jax_default_cfg()).run_ddim(
        lambda x, t: jp.apply(params, x, t.astype(jnp.float32)),
        jax.random.PRNGKey(0), b, (style,), steps, kappa=0.0,
        mixing_logit=logit, x_noisy=jnp.asarray(x0))
    with torch.no_grad():
        got = DiffusionDiscretized(get_default_cfg()).run_ddim(
            m, b, (style,), steps, kappa=0.0,
            mixing_logit=m.mixing_logit if mixed else None,
            x_noisy=torch.from_numpy(x0))
    # a dense fp32 ResNet per step (1e-5 per call); x_0 = (x - sqrt(1 -
    # a_t) eps) / sqrt(a_t) grows the random prior's output to O(100), so
    # the bound is 1e-5 of the output's size
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_run_ddim_matches_jax_through_the_local_prior():
    """The tiny local prior, conditioned, on the flat (B, N * C) latent."""
    cfg = tiny_cfg(get_default_cfg(), 64, steps=100)
    jcfg = tiny_cfg(jax_default_cfg(), 64, steps=100)
    b, steps = 2, 5
    x0 = clouds(28, b, 64 * 4, scale=1.0)
    cond = clouds(29, b, 128, scale=1.0)
    m = LocalPrior(cfg).eval()
    init_weights(m, torch.Generator().manual_seed(6))
    jp = JLocalPrior(jcfg)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, to_jax_tree(m))}
    want = JaxDD(jcfg).run_ddim(
        lambda x, t: jp.apply(params, x, t.astype(jnp.float32),
                              condition_input=jnp.asarray(cond)),
        jax.random.PRNGKey(0), b, (64 * 4,), steps, skip_type="quad",
        kappa=0.0, x_noisy=jnp.asarray(x0))
    with torch.no_grad():
        got = DiffusionDiscretized(cfg).run_ddim(
            lambda x, t: m(x, t, condition_input=torch.from_numpy(cond)), b,
            (64 * 4,), steps, skip_type="quad", kappa=0.0,
            x_noisy=torch.from_numpy(x0))
    # the U-Net matches the JAX one to 2e-4 per call
    # (tests/test_torch_port_nn.py); five steps carry it on
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_lion_sample_ddim():
    """The DDIM branch of LION.sample: finite points, the same draws give
    the same samples, and given_noise stays an ancestral-only option."""
    cfg = tiny_cfg(get_default_cfg(), 64, steps=20)
    cfg.sde.ddim_skip_type = "quad"
    lion = LION(cfg, device=CPU).init_params(torch.Generator().manual_seed(7))
    out = [lion.sample(2, generator=torch.Generator().manual_seed(8),
                       ddim_step=4) for _ in range(2)]
    assert out[0]["points"].shape == (2, 64, 3)
    assert torch.isfinite(out[0]["points"]).all()
    torch.testing.assert_close(out[0]["points"], out[1]["points"], rtol=0,
                               atol=0)
    ancestral = lion.sample(2, generator=torch.Generator().manual_seed(8))
    assert not torch.equal(ancestral["points"], out[0]["points"])
    with pytest.raises(ValueError, match="given_noise"):
        lion.sample(2, given_noise=((None, None), (None, None)), ddim_step=4)
