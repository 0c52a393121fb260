"""The port's sampling slice end to end against the JAX package on CPU.

A tiny LION (64 points, a three-stage U-Net, a narrow global prior, 5 DDPM
steps) is built in both packages; the JAX params cross through the bridge
(ckpt/from_jax.py) and both chains take the same given noise, so the final
points must agree at fp32 tolerance. The helpers here are shared with
test_torch_port_nn.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.vae import VAE as JaxVAE

from lion_tpu_torch.config import flagship_cfg, get_default_cfg
from lion_tpu_torch.diffusion import DiffusionDiscretized
from lion_tpu_torch.models import LION

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
N = 64


def tiny_cfg(cfg, num_points=64, steps=5):
    """Small shapes, same code paths: three U-Net stages (the middle one has
    conv attention), r = 4 grids, K = 4 neighbours, a narrow global prior."""
    cfg.data.tr_max_sample_points = num_points
    cfg.shapelatent.latent_dim = 1
    cfg.shapelatent.encoder_type = "models.latent_points_ada.PointTransPVC"
    cfg.shapelatent.decoder_type = "models.latent_points_ada.LatentPointDecPVC"
    cfg.latent_pts.ada_mlp_init_scale = 0.1
    cfg.latent_pts.skip_weight = 0.01
    cfg.ddpm.num_steps = steps
    cfg.sde.num_channels_dae = 32
    cfg.sde.num_cell_per_scale_dae = 2
    cfg.sde.embedding_dim = 16
    cfg.tpu.sa_blocks = [[[8, 1, 4], [32, 0.3, 4, [8, 16]]],
                         [[16, 1, 4], [8, 0.5, 4, [16, 16]]],
                         [None, [4, 0.8, 4, [16, 16]]]]
    cfg.tpu.fp_blocks = [[[16, 16], [16, 1, 4]],
                         [[16, 16], [16, 1, 4]],
                         [[16, 8], [8, 1, 4]]]
    return cfg


def to_jax_tree(module: torch.nn.Module) -> dict:
    """The port's parameters as the nested numpy dict of a flax tree (the
    inverse of ckpt/from_jax.py), so a port-initialized model can run in the
    JAX package without compiling a flax init."""
    tree = {}
    for name, p in module.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().cpu().numpy().copy()
    return tree


def shape_tree(tree) -> dict:
    """{dotted path: shape} of a (possibly abstract) param tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(k.key for k in path): tuple(v.shape)
            for path, v in flat}


def assert_same_params(module: torch.nn.Module, jax_tree) -> None:
    """The port module has exactly the JAX tree's leaf names and shapes."""
    mine = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert mine == shape_tree(jax_tree)


def jax_param_shapes(lion):
    """Abstract (traced, not compiled) params of what sampling runs: the
    priors and the VAE decoder."""
    def init_all():
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        t = jnp.ones((1,))
        gp = lion.global_prior.init(k1, jnp.zeros((1, lion.style_dim)), t)
        lp = lion.local_prior.init(
            k2, jnp.zeros((1, lion.local_dim)), t,
            condition_input=jnp.zeros((1, lion.style_dim)))
        vae = lion.vae.init({"params": k3, "sample": k3}, 1,
                            method=JaxVAE.sample)
        return {"vae": vae["params"], "global_prior": gp["params"],
                "local_prior": lp["params"]}
    return jax.eval_shape(init_all)


def test_default_cfg_equals_lion_tpu():
    assert get_default_cfg().to_dict() == jax_default_cfg().to_dict()
    assert tiny_cfg(get_default_cfg(), N, STEPS).to_dict() == \
        tiny_cfg(jax_default_cfg(), N, STEPS).to_dict()


def test_flagship_cfg_is_the_released_prior_shape():
    cfg = flagship_cfg()
    assert cfg.data.tr_max_sample_points == 2048
    assert cfg.shapelatent.latent_dim == 1
    assert cfg.sde.num_channels_dae == 2048
    assert cfg.sde.num_cell_per_scale_dae == 8
    assert cfg.tpu.bf16 is False


def test_schedule_constants_match_lion_tpu():
    from lion_tpu.diffusion.discrete import DiffusionDiscretized as JaxDD
    cfg = get_default_cfg()
    mine, ref = DiffusionDiscretized(cfg), JaxDD(jax_default_cfg())
    for name in ("betas", "alphas", "alpha_bars"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      np.asarray(getattr(ref, name)))


def test_sample_matches_lion_tpu_with_shared_noise():
    """Port-initialized weights cross to the JAX package as a flax tree
    (whose names and shapes must be the JAX init's) and back through
    load_jax_params."""
    lion = LION(tiny_cfg(get_default_cfg(), N, STEPS)).init_params(
        torch.Generator().manual_seed(0))
    params = to_jax_tree(lion)
    jlion = JaxLION(tiny_cfg(jax_default_cfg(), N, STEPS))
    assert_same_params(lion, jax_param_shapes(jlion))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, params)
    lion = LION(tiny_cfg(get_default_cfg(), N, STEPS)).load_jax_params(
        params)

    rs = np.random.RandomState(11)
    b = 2
    noise = ((rs.randn(b, 128), rs.randn(STEPS, b, 128)),
             (rs.randn(b, N * 4), rs.randn(STEPS, b, N * 4)))
    noise = jax.tree_util.tree_map(lambda a: a.astype(np.float32), noise)
    want = jlion.sample(num_samples=b, given_noise=jax.tree_util.tree_map(
        jnp.asarray, noise))
    got = lion.sample(b, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, noise))

    assert got["points"].shape == (b, N, 3)
    # fp32 through 5 steps of two priors and a decode, with the sums of
    # every matmul, conv and norm taken in another order
    np.testing.assert_allclose(got["z_global"].numpy(),
                               np.asarray(want["z_global"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["z_local"].numpy(),
                               np.asarray(want["z_local"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["points"].numpy(),
                               np.asarray(want["points"]), rtol=1e-4,
                               atol=1e-4)


def test_flagship_sample_matches_lion_tpu():
    """The released shapes: 2048 points, the local-prior and decoder U-Nets
    at their released specs, a 2048-wide global prior; 2 DDPM steps."""
    import __graft_entry__
    jcfg = __graft_entry__._flagship_cfg()
    jcfg.sde.num_channels_dae = 2048
    jcfg.ddpm.num_steps = 2
    cfg = flagship_cfg()
    cfg.ddpm.num_steps = 2
    assert cfg.to_dict() == jcfg.to_dict()
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    jlion = JaxLION(jcfg)
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))

    rs = np.random.RandomState(13)
    noise = ((rs.randn(1, 128), rs.randn(2, 1, 128)),
             (rs.randn(1, 2048 * 4), rs.randn(2, 1, 2048 * 4)))
    noise = jax.tree_util.tree_map(lambda a: a.astype(np.float32), noise)
    want = jlion.sample(num_samples=1, given_noise=jax.tree_util.tree_map(
        jnp.asarray, noise))
    got = lion.sample(1, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, noise))
    assert got["points"].shape == (1, 2048, 3)
    # fp32 through the full-width networks, sums in another order
    for k in ("z_global", "z_local", "points"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mixed", [False, True])
def test_ancestral_chain_matches_lion_tpu(mixed):
    """run_denoising_diffusion on a toy eps model, with and without mixed
    prediction, over the default 1000-step schedule."""
    from lion_tpu.diffusion.discrete import DiffusionDiscretized as JaxDD
    rs = np.random.RandomState(12)
    b, d, steps = 3, 6, 1000
    w = rs.randn(d, d).astype(np.float32) * 0.1
    logit = rs.randn(d).astype(np.float32) if mixed else None
    x0 = rs.randn(b, d).astype(np.float32)
    noise = rs.randn(steps, b, d).astype(np.float32)

    def jfn(x, t):
        return jnp.tanh(x @ w) + 1e-3 * t[:, None]

    def tfn(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) + 1e-3 * t[:, None]

    want = JaxDD(jax_default_cfg()).run_denoising_diffusion(
        jfn, jax.random.PRNGKey(0), b, (d,),
        mixing_logit=None if logit is None else jnp.asarray(logit),
        x_noisy=jnp.asarray(x0), given_noise=jnp.asarray(noise))
    got = DiffusionDiscretized(get_default_cfg()).run_denoising_diffusion(
        tfn, b, (d,),
        mixing_logit=None if logit is None else torch.from_numpy(logit),
        x_noisy=torch.from_numpy(x0), given_noise=torch.from_numpy(noise))
    # 1000 fp32 steps; per-step scalars agree to an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_sample_chunked_equals_sample():
    cfg = tiny_cfg(get_default_cfg(), N, STEPS)
    lion = LION(cfg).init_params(torch.Generator().manual_seed(3))
    a = lion.sample(2, generator=torch.Generator().manual_seed(5))
    c = lion.sample_chunked(2, generator=torch.Generator().manual_seed(5),
                            chunks=5)
    torch.testing.assert_close(a["points"], c["points"], rtol=0, atol=0)
    assert torch.isfinite(a["points"]).all()
    with pytest.raises(ValueError, match="must divide"):
        lion.sample_chunked(2, chunks=2)


def test_import_leaves_jax_out():
    code = ("import sys, lion_tpu_torch, lion_tpu_torch.models, "
            "lion_tpu_torch.ops, lion_tpu_torch.ckpt;"
            "bad = [m for m in ('jax', 'flax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
