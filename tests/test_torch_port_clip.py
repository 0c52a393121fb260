"""CLIP conditioning (clipforge.enable) in the port against the JAX package
on the CPU, with the HashClip stand-in (no CLIP weights here; the hub is
kept offline).

- `HashClip` text and image features equal lion_tpu's bit for bit, and
  `get_clip_encoder` falls back to it as lion_tpu's does.
- The 'se_clip' global prior (PriorSEClip) and the CLIP-mapped local prior
  against lion_tpu's on the same weights and features: 1e-4 of the
  output's size.
- A CLIP-conditioned `LION.sample` under `given_noise` (1e-4) and the
  two-prior step (the loss within 1e-5, the gradients within 1e-4 over
  all and 1e-3 a tensor) on lion_tpu's draws and latents: both priors
  read lion_tpu's encoded eps, since the two VAE encoders' own difference
  (held to 2e-4 by tests/test_torch_port_train.py) moves these CLIP-
  conditioned gradients by 1.2e-4 to 2.8e-4 (seeds 1-4); on the same eps
  they agree to 1.4e-5.
- The `.pt` export of the CLIP keys (clip_feat_mapping, clip_forge_mapping,
  style_clip) bit-equal to lion_tpu's, and its import back.
- The loader's render views (PNG files written here) bit-equal to
  lion_tpu's batches, the error without PIL, and the two-prior and
  single-prior trainers under clipforge.enable for an epoch.
- `demo --text` and `demo --clip_feat` against the root demo.py on one
  checkpoint, the port's chains fed lion_tpu's draws re-made from its key:
  1e-4.
"""
import builtins
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lion_tpu.ckpt import torch_import as jti
from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.data import shapenet as jshapenet
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.registry import build_global_prior as jax_global_prior
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_prior_step
from lion_tpu.utils import clip_helper as jclip

from lion_tpu_torch import demo
from lion_tpu_torch.ckpt import io
from lion_tpu_torch.ckpt import torch_import as ti
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.data import shapenet
from lion_tpu_torch.models import LION, build_global_prior
from lion_tpu_torch.nn import init_weights
from lion_tpu_torch.trainers import prior_loss
from lion_tpu_torch.trainers.train_2prior import Trainer as TwoPrior
from lion_tpu_torch.trainers.train_prior import Trainer as SinglePrior
from lion_tpu_torch.utils import clip_helper

from test_torch_port_sample import (one_torch_thread,  # noqa: F401
                                    tiny_cfg, to_jax_tree)
from test_torch_port_stage2 import _chain_noise, stage2_cfg
from test_torch_port_train import (_flat, _grad_bounds, _port_grads, _rho,
                                   noise, train_cfg)
from test_torch_port_trainer import SYNSET, _Args

FEAT = 512
STEPS = 5


@pytest.fixture(autouse=True)
def offline_hub(monkeypatch):
    """No network: the hub reads its cache only, and no CLIP weights are
    named."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.delenv("LION_CLIP_MODEL", raising=False)
    monkeypatch.delenv("LION_CLIP_ONLINE", raising=False)


def clip_cfg(cfg, base=tiny_cfg):
    cfg = base(cfg)
    cfg.clipforge.enable = 1
    cfg.latent_pts.style_prior = "models.score_sde.resnet.PriorSEClip"
    return cfg


def _feats(seed, b):
    return jclip.HashClip().encode_text([f"shape {seed} {i}"
                                         for i in range(b)])


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ----------------------------------------------------------------- clip
def test_hash_clip_equals_lion_tpus():
    prompts = ["a chair", "an airplane", "a chair"]
    got = clip_helper.HashClip().encode_text(prompts)
    assert np.array_equal(got, jclip.HashClip().encode_text(prompts))
    assert got.dtype == np.float32 and got.shape == (3, FEAT)
    assert np.array_equal(got[0], got[2]) and not np.allclose(got[0], got[1])
    imgs = np.random.RandomState(0).randint(0, 255, (2, 8, 8, 3), np.uint8)
    assert np.array_equal(clip_helper.HashClip().encode_image(imgs),
                          jclip.HashClip().encode_image(imgs))
    enc = clip_helper.get_clip_encoder("this-model/does-not-exist")
    assert isinstance(enc, clip_helper.HashClip) and not enc.is_real
    with pytest.raises(Exception):
        clip_helper.get_clip_encoder("this-model/does-not-exist",
                                     allow_fallback=False)


# --------------------------------------------------------------- priors
def test_se_clip_global_prior_matches_lion_tpu():
    """tests/test_extras.py's PriorSEClip (nf 32, one block), two blocks
    here."""
    cfgs = []
    for make in (get_default_cfg, jax_default_cfg):
        cfg = make()
        cfg.clipforge.enable = 1
        cfg.latent_pts.style_prior = "models.score_sde.resnet.PriorSEClip"
        cfg.sde.num_channels_dae = 32
        cfg.sde.num_cell_per_scale_dae = 2
        cfg.sde.embedding_dim = 16
        cfgs.append(cfg)
    prior = build_global_prior(cfgs[0])
    init_weights(prior, torch.Generator().manual_seed(4))
    prior.eval()
    assert set(dict(prior.named_parameters())) >= {
        "clip_feat_mapping.kernel", "block1.conv1.kernel"}
    assert prior.block0.conv1.kernel.shape == (64, 32)
    x = noise(3, 3, 128)
    t = np.array([1.0, 40.0, 900.0], np.float32)
    feat = _feats(1, 3)
    got = prior(torch.from_numpy(x), torch.from_numpy(t),
                clip_feat=torch.from_numpy(feat))
    want = jax_global_prior(cfgs[1]).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, to_jax_tree(prior))},
        jnp.asarray(x), jnp.asarray(t), clip_feat=jnp.asarray(feat))
    _close(got.detach().numpy(), want)
    with pytest.raises(ValueError, match="clip_feat"):
        prior(torch.from_numpy(x), torch.from_numpy(t))


@pytest.fixture(scope="module")
def pair():
    cfg = clip_cfg(get_default_cfg(), lambda c: tiny_cfg(c, 64, STEPS))
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(6))
    jlion = JaxLION(clip_cfg(jax_default_cfg(),
                             lambda c: tiny_cfg(c, 64, STEPS)))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    return lion, jlion


def test_clip_local_prior_matches_lion_tpu(pair):
    lion, jlion = pair
    names = dict(lion.local_prior.named_parameters())
    assert names["unet.clip_forge_mapping.kernel"].shape == (FEAT, 64)
    assert names["unet.style_clip.kernel"].shape == (128 + 64, 128)
    x = noise(5, 2, 64 * 4)
    cond = noise(6, 2, 128)
    t = np.array([3.0, 1.0], np.float32)
    feat = _feats(2, 2)
    lion.eval()
    with torch.no_grad():
        got = lion.local_prior(torch.from_numpy(x), torch.from_numpy(t),
                               condition_input=torch.from_numpy(cond),
                               clip_feat=torch.from_numpy(feat))
    want = jax.jit(lambda p, xx, tt, cc, ff: jlion.local_prior.apply(
        {"params": p}, xx, tt, condition_input=cc, clip_feat=ff))(
            jlion.params["local_prior"], jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(cond), jnp.asarray(feat))
    _close(got.numpy(), want)


def test_clip_sample_matches_lion_tpu(pair):
    lion, jlion = pair
    b, d_l = 2, 64 * 4
    rs = np.random.RandomState(12)
    given = ((rs.randn(b, 128), rs.randn(STEPS, b, 128)),
             (rs.randn(b, d_l), rs.randn(STEPS, b, d_l)))
    given = jax.tree_util.tree_map(lambda a: a.astype(np.float32), given)
    feat = _feats(3, b)
    want = jlion.sample(num_samples=b, clip_feat=jnp.asarray(feat),
                        given_noise=jax.tree_util.tree_map(jnp.asarray,
                                                           given))
    got = lion.sample(b, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, given), clip_feat=feat)
    for k in ("z_global", "z_local", "points"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    other = lion.sample(b, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, given), clip_feat=_feats(4, b))
    assert not torch.allclose(other["points"], got["points"])


def test_clip_prior_step_matches_lion_tpu(monkeypatch):
    cfg = clip_cfg(get_default_cfg(), train_cfg)
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    jlion = JaxLION(clip_cfg(jax_default_cfg(), train_cfg))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    b, n = 2, 64
    x = noise(10, b, n, 3, scale=0.3)
    feat = _feats(5, b)
    opt = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, 0.0)
    step = jax.jit(jax_prior_step(jlion.vae, jlion.global_prior,
                                  jlion.local_prior, jlion.diffusion, opt,
                                  jlion.cfg))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng, clip_feat=jnp.asarray(feat))
    rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(rng, 5)
    eps, _, latent_list = jax.jit(lambda p, xx: jlion.vae.apply(
        {"params": p}, xx, method=JaxVAE.encode,
        rngs={"sample": rng_enc}))(jlion.params["vae"], jnp.asarray(x))
    t = (jax.random.uniform(rng_t, (b,)) * jlion.diffusion.num_steps
         ).astype(jnp.int32) + 1
    # the priors' inputs: lion_tpu's encoded latents
    monkeypatch.setattr(lion.vae, "encode", lambda xx, gen=None, rho=None: (
        torch.from_numpy(np.array(eps)), None, None))
    loss, got = prior_loss(
        lion, torch.from_numpy(x), rho=_rho(latent_list),
        timestep=torch.from_numpy(np.array(t)),
        noise=(torch.from_numpy(np.array(jax.random.normal(rng_n0,
                                                           (b, 128)))),
               torch.from_numpy(np.array(jax.random.normal(
                   rng_n1, (b, eps.shape[1] - 128))))),
        clip_feat=torch.from_numpy(feat))
    loss.backward()
    for k in ("loss", "train/p_loss_0", "train/p_loss_1"):
        np.testing.assert_allclose(float(got[k].detach()),
                                   float(metrics[k]), rtol=1e-5)
    grads = {**_port_grads(lion.global_prior, "global_prior."),
             **_port_grads(lion.local_prior, "local_prior.")}
    for k in ("global_prior.clip_feat_mapping.kernel",
              "local_prior.unet.clip_forge_mapping.kernel",
              "local_prior.unet.style_clip.kernel"):
        assert float(grads[k].abs().sum()) > 0, k
    _grad_bounds(grads, {
        **_flat(new_state.opt_state["global_prior"], "global_prior."),
        **_flat(new_state.opt_state["local_prior"], "local_prior.")})


def test_clip_keys_round_trip_the_pt_export(pair):
    lion, _ = pair
    arrays = io.tensors_tree(*zip(*lion.named_parameters()))
    for model, prefix, key in (
            ("global_prior", "0", "0.clip_feat_mapping.weight"),
            ("local_prior", "1", "1.clip_forge_mapping.weight"),
            ("local_prior", "1", "1.style_clip.weight")):
        got = ti.export_state_dict(arrays[model], model, prefix)
        want = jti.export_state_dict(arrays[model], model, prefix)
        assert key in got and set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        back = ti.import_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in got.items()},
            ti.module_tree(getattr(lion, model)), model, prefix)
        flat_back, flat_src = io.flatten_tree(back), \
            io.flatten_tree(arrays[model])
        assert set(flat_back) == set(flat_src)
        for k, v in flat_src.items():
            np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))


# --------------------------------------------------------- data, trainers
@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    """A PointFlow tree (8 training, 4 test clouds) and, beside it, two
    PNG render views a shape under <renders>/<synset>/<id>/img_choy2016."""
    from PIL import Image
    root = tmp_path_factory.mktemp("clip_data")
    rng = np.random.RandomState(2)
    for split, count in (("train", 8), ("val", 4), ("test", 4)):
        d = root / "pc" / SYNSET / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"s{split}{i}.npy"),
                    (rng.randn(2048, 3) * 0.2).astype(np.float32))
            views = root / "renders" / SYNSET / f"s{split}{i}" / "img_choy2016"
            views.mkdir(parents=True)
            for v in range(2):
                Image.fromarray(rng.randint(0, 255, (12, 12, 3), np.uint8)
                                ).save(str(views / f"{v:03d}.png"))
    return str(root / "pc"), str(root / "renders")


def _clip_data(cfg, renders):
    cfg.data.cates = "airplane"
    cfg.data.clip_forge_enable = 1
    cfg.data.clip_img_root = renders
    return cfg


def test_render_views_equal_lion_tpus_batches(clip_root):
    pc, renders = clip_root
    got = shapenet.get_data_loaders(
        _clip_data(get_default_cfg(), renders).data, pc, seed=3)
    want = jshapenet.get_data_loaders(
        _clip_data(jax_default_cfg(), renders).data, pc, seed=3)
    for name in ("train_loader", "test_loader"):
        for a, b in zip(got[name], want[name]):
            assert a["tr_img"].shape[1:] == (5, 224, 224, 3)
            assert a["tr_img"].dtype == np.uint8
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_render_views_without_pil_raise_at_build(clip_root, monkeypatch):
    pc, renders = clip_root
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kwargs)
    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="data.clip_forge_enable reads"):
        shapenet.get_datasets(_clip_data(get_default_cfg(), renders).data,
                              pc)


@pytest.mark.parametrize("cls", [TwoPrior, SinglePrior])
def test_trainers_run_with_clipforge(tmp_path, clip_root, cls):
    pc, renders = clip_root
    cfg = _clip_data(clip_cfg(get_default_cfg(), lambda c: stage2_cfg(
        c, str(tmp_path), pc)), renders)
    cfg.trainer.epochs = 1
    cfg.viz.val_freq = 1
    pt = cls(cfg, _Args(str(tmp_path), pc), device="cpu")
    assert not pt.clip_encoder.is_real
    batch = next(iter(pt.train_loader))
    feat = pt.conditions(batch)["clip_feat"]
    flat = batch["tr_img"].reshape(-1, *batch["tr_img"].shape[2:])
    want = jclip.HashClip().encode_image(flat).reshape(
        len(batch["tr_img"]), 5, -1).mean(axis=1)
    assert np.array_equal(feat.numpy(), want.astype(np.float32))
    pt.train_epochs()
    assert pt.step == len(pt.train_loader) == 2
    assert all(torch.isfinite(p).all() for p in pt.step_fn.params)
    pts = pt.sample(3, generator=torch.Generator().manual_seed(1))
    assert pts.shape == (3, 32, 3) and torch.isfinite(pts).all()
    pt.writer.close()


# ----------------------------------------------------------------- demo
def _jax_demo_draws(seed, n, cfg):
    """lion_tpu's ancestral draws of `LION.sample` at PRNGKey(seed)
    (models/lion.py `_sample_impl`: the key split in three, each chain's
    init from its first split, the per-step draws from the rest)."""
    rng_g, rng_l, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    given = []
    for rng, d in ((rng_g, 128), (rng_l, cfg.data.tr_max_sample_points * 4)):
        rng, init = jax.random.split(rng)
        given.append((torch.from_numpy(np.array(jax.random.normal(
            init, (n, d)))), _chain_noise(rng, cfg.ddpm.num_steps, (n, d))))
    return tuple(given)


@pytest.mark.parametrize("flag", ["--text", "--clip_feat"])
def test_demo_conditions_as_lion_tpus(tmp_path, pair, monkeypatch, flag):
    import demo as jax_demo
    lion, _ = pair
    cfg_yml, ckpt = str(tmp_path / "cfg.yml"), str(tmp_path / "lion.npz")
    lion.cfg.save(cfg_yml)
    io.save_checkpoint(ckpt, {"vae": io.module_arrays(lion.vae),
                              "dae_global": io.module_arrays(
                                  lion.global_prior),
                              "dae_local": io.module_arrays(
                                  lion.local_prior)}, {})
    n, seed = 2, 3
    if flag == "--text":
        value = "a tall chair"
    else:
        value = str(tmp_path / "feat.npy")
        np.save(value, _feats(7, n))
    argv = ["--config", cfg_yml, "--ckpt", ckpt, "--num_samples", str(n),
            "--seed", str(seed), flag, value]
    want_npz, got_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["demo.py", *argv, "--out", want_npz])
    jax_demo.main()

    given = _jax_demo_draws(seed, n, lion.cfg)
    sample = LION.sample
    monkeypatch.setattr(LION, "sample", lambda self, num, gen, **kw: sample(
        self, num, gen, given_noise=given, **kw))
    demo.main(argv + ["--out", got_npz, "--device", "cpu"])
    with np.load(got_npz) as got, np.load(want_npz) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
