"""Class conditioning (data.cond_on_cat) in the port against the JAX package
on the CPU, on tests/test_conditioning.py's config (32 points, 5 classes,
an 8-wide class embedding, a two-stage U-Net), the style encoder shrunk by
the size multipliers as tests/test_torch_port_train.py's `train_cfg` does
(its fixed 1024-center specs drift ~1e-3 between the packages on 32
points) and dropout 0 (the packages' random bits differ).

- `embed_class`: int labels and one-hot rows give the same rows, equal to
  lion_tpu's.
- The VAE's `get_loss` (train mode) and `recont` (eval mode) with labels:
  the loss within 1e-5, the reconstruction within 1e-4 of its size.
- A labelled `LION.sample` under `given_noise`: 1e-4.
- The labelled two-prior and stage-1 steps against lion_tpu's on its
  draws: the loss within 1e-5, the gradients within 1e-4 over all and
  1e-3 a tensor (tests/test_torch_port_train.py's `_grad_bounds`). They
  run on that file's step config (64 points, three stages, B = 2) with
  the classes on: on the 32-point config above the two packages'
  gradients differ by 1.5e-4 already without labels (their AdaGN style
  kernels at the first stage), beyond the bound.
- Both trainers on a two-category synthetic split, and the stage-1
  trainer's `.npz` checkpoints both ways with a lion_tpu Trainer,
  `class_embedding` included.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_prior_step
from lion_tpu.trainers.steps import make_vae_train_step as jax_vae_step

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.config.view import as_view
from lion_tpu_torch.models import LION
from lion_tpu_torch.trainers import (make_vae_train_step, prior_loss,
                                     warmup_cosine_schedule)
from lion_tpu_torch.trainers.train_2prior import Trainer as TwoPrior

from test_conditioning import cond_cfg as jax_cond_cfg
from test_torch_port_sample import one_torch_thread, to_jax_tree  # noqa: F401
from test_torch_port_train import (_flat, _grad_bounds, _port_grads, _rho,
                                   noise, train_cfg)
from test_torch_port_trainer import (_Args, _assert_trainer_holds,
                                     _jax_state, _jax_trainer, _port_trainer,
                                     trainer_cfg)

N, B, NCLASS, EMB = 32, 4, 5, 8
LABELS = np.array([0, 1, 2, 4], np.int32)
SYNSETS = ("02691156", "03001627")   # airplane, chair


def cond_cfg(cfg):
    """tests/test_conditioning.py:20-47 on `cfg`, the style encoder shrunk
    (train_cfg's multipliers, the U-Net specs scaled back up), dropout 0
    and a wide prior step's ema."""
    cfg.data.tr_max_sample_points = N
    cfg.data.cond_on_cat = 1
    cfg.data.nclass = NCLASS
    cfg.tpu.cls_emb_dim = EMB
    cfg.shapelatent.latent_dim = 1
    cfg.shapelatent.encoder_type = "models.latent_points_ada.PointTransPVC"
    cfg.shapelatent.decoder_type = "models.latent_points_ada.LatentPointDecPVC"
    cfg.latent_pts.ada_mlp_init_scale = 0.1
    cfg.latent_pts.skip_weight = 0.01
    cfg.shapelatent.log_sigma_offset = 6.0
    cfg.latent_pts.pvd_mse_loss = 1
    cfg.ddpm.num_steps = 4
    cfg.ddpm.loss_type = "l1_sum"
    cfg.sde.num_channels_dae = 16
    cfg.sde.num_cell_per_scale_dae = 1
    cfg.sde.embedding_dim = 8
    cfg.tpu.sa_blocks = [[[8, 1, 4], [8, 0.2, 4, [8, 16]]],
                         [None, [4, 0.4, 4, [16, 16]]]]
    cfg.tpu.fp_blocks = [[[16, 16], [16, 1, 4]], [[16, 8], [8, 1, 4]]]
    return cfg


def shrunk(cfg):
    cfg.ddpm.dropout = 0.0
    cfg.sde.dropout = 0.0
    cfg.tpu.ncenter_mult, cfg.tpu.vres_mult = 1 / 32, 1 / 4
    for conv, sa in cfg.tpu.sa_blocks:
        if conv is not None:
            conv[2] *= 4
        sa[0] *= 32
    for _, conv in cfg.tpu.fp_blocks:
        conv[2] *= 4
    return cfg


@pytest.fixture(scope="module")
def pair():
    """The class-conditional LION in both packages on one port init."""
    cfg = shrunk(cond_cfg(get_default_cfg()))
    jcfg = shrunk(cond_cfg(jax_default_cfg()))
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    jlion = JaxLION(jcfg)
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    return lion, jlion


@pytest.fixture(scope="module")
def step_pair():
    """tests/test_torch_port_train.py's step config with the classes on,
    in both packages on one port init."""
    def classes(cfg):
        cfg = train_cfg(cfg)
        cfg.data.cond_on_cat, cfg.data.nclass = 1, NCLASS
        cfg.tpu.cls_emb_dim = EMB
        return cfg
    lion = LION(classes(get_default_cfg()), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    jlion = JaxLION(classes(jax_default_cfg()))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    return lion, jlion


STEP_B, STEP_N = 2, 64
STEP_LABELS = np.array([1, 3], np.int32)


def test_config_is_test_conditionings():
    assert cond_cfg(get_default_cfg()).to_dict() == jax_cond_cfg().to_dict()


def test_embed_class_int_equals_one_hot_and_lion_tpu(pair):
    lion, jlion = pair
    got = lion.vae.embed_class(torch.from_numpy(LABELS))
    one_hot = torch.nn.functional.one_hot(torch.from_numpy(LABELS).long(),
                                          NCLASS).float()
    assert torch.equal(got, lion.vae.embed_class(one_hot))
    assert torch.equal(got, lion.class_condition(LABELS))
    want = jlion.vae.apply({"params": jlion.params["vae"]},
                           jnp.asarray(LABELS), method=JaxVAE.embed_class)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert got.shape == (B, EMB)


def test_vae_loss_and_recont_with_labels_match_lion_tpu(pair):
    lion, jlion = pair
    vae, jvae, params = lion.vae, jlion.vae, jlion.params["vae"]
    x = noise(1, B, N, 3, scale=0.1)
    labels = jnp.asarray(LABELS)
    want = jvae.apply({"params": params}, jnp.asarray(x), class_label=labels,
                      method=JaxVAE.get_loss,
                      rngs={"sample": jax.random.PRNGKey(2),
                            "dropout": jax.random.PRNGKey(5)})
    vae.train()
    got = vae.get_loss(torch.from_numpy(x), rho=_rho(want["latent_list"]),
                       class_label=torch.from_numpy(LABELS))
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(want["loss"]), rtol=1e-5)
    size = float(np.abs(np.asarray(want["x_0_pred"])).max())
    np.testing.assert_allclose(got["x_0_pred"].detach().numpy(),
                               np.asarray(want["x_0_pred"]), rtol=0,
                               atol=1e-4 * size)
    np.testing.assert_allclose(got["cls_emb"].detach().numpy(),
                               np.asarray(want["cls_emb"]), rtol=1e-6,
                               atol=1e-7)

    want = jvae.apply({"params": params}, jnp.asarray(x), class_label=labels,
                      method=JaxVAE.recont,
                      rngs={"sample": jax.random.PRNGKey(4)})
    vae.eval()
    with torch.no_grad():
        got = vae.recont(torch.from_numpy(x), rho=_rho(want["latent_list"]),
                         class_label=LABELS)
    size = float(np.abs(np.asarray(want["x_0_pred"])).max())
    np.testing.assert_allclose(got["x_0_pred"].numpy(),
                               np.asarray(want["x_0_pred"]), rtol=0,
                               atol=1e-4 * size)
    with pytest.raises(ValueError, match="class_label"):
        vae.recont(torch.from_numpy(x))


def test_labelled_sample_matches_lion_tpu(pair):
    lion, jlion = pair
    rs = np.random.RandomState(11)
    d_l = N * 4
    given = ((rs.randn(B, 128), rs.randn(4, B, 128)),
             (rs.randn(B, d_l), rs.randn(4, B, d_l)))
    given = jax.tree_util.tree_map(lambda a: a.astype(np.float32), given)
    want = jlion.sample(num_samples=B, class_label=jnp.asarray(LABELS),
                        given_noise=jax.tree_util.tree_map(jnp.asarray,
                                                           given))
    got = lion.sample(B, given_noise=jax.tree_util.tree_map(torch.from_numpy,
                                                            given),
                      class_label=LABELS)
    for k in ("z_global", "z_local", "points"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the labels condition the sample; without them it refuses
    other = lion.sample(B, given_noise=jax.tree_util.tree_map(
        torch.from_numpy, given), class_label=[1, 1, 1, 1])
    assert not torch.allclose(other["points"], got["points"])
    with pytest.raises(ValueError, match="class_label"):
        lion.sample(B)


def test_ode_sampling_refuses_class_labels(pair):
    lion, _ = pair
    lion.cfg.sde.ode_sample = 1
    try:
        with pytest.raises(ValueError, match="PF-ODE"):
            lion.sample(2, class_label=[0, 1])
    finally:
        lion.cfg.sde.ode_sample = 0


def _capture():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_labelled_prior_step_matches_lion_tpu(step_pair):
    lion, jlion = step_pair
    B, N, LABELS = STEP_B, STEP_N, STEP_LABELS
    x = noise(10, B, N, 3, scale=0.3)
    opt = _capture()
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, 0.0)
    step = jax.jit(jax_prior_step(jlion.vae, jlion.global_prior,
                                  jlion.local_prior, jlion.diffusion, opt,
                                  jlion.cfg))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng, class_label=jnp.asarray(LABELS))
    rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(rng, 5)
    eps, _, latent_list = jax.jit(lambda p, xx: jlion.vae.apply(
        {"params": p}, xx, method=JaxVAE.encode,
        rngs={"sample": rng_enc}))(jlion.params["vae"], jnp.asarray(x))
    t = (jax.random.uniform(rng_t, (B,)) * jlion.diffusion.num_steps
         ).astype(jnp.int32) + 1
    n0 = jax.random.normal(rng_n0, (B, 128))
    n1 = jax.random.normal(rng_n1, (B, eps.shape[1] - 128))
    lion.zero_grad()
    loss, got = prior_loss(
        lion, torch.from_numpy(x), rho=_rho(latent_list),
        timestep=torch.from_numpy(np.array(t)),
        noise=(torch.from_numpy(np.array(n0)),
               torch.from_numpy(np.array(n1))),
        class_label=torch.from_numpy(LABELS))
    loss.backward()
    for k in ("loss", "train/p_loss_0", "train/p_loss_1"):
        np.testing.assert_allclose(float(got[k].detach()),
                                   float(metrics[k]), rtol=1e-5)
    _grad_bounds(
        {**_port_grads(lion.global_prior, "global_prior."),
         **_port_grads(lion.local_prior, "local_prior.")},
        {**_flat(new_state.opt_state["global_prior"], "global_prior."),
         **_flat(new_state.opt_state["local_prior"], "local_prior.")})
    # the class embedding is the frozen VAE's: no gradient reaches it
    assert lion.vae.class_embedding.kernel.grad is None
    lion.zero_grad()


def test_labelled_vae_step_matches_lion_tpu(step_pair):
    lion, jlion = step_pair
    B, N, LABELS = STEP_B, STEP_N, STEP_LABELS
    vae, jvae = lion.vae, jlion.vae
    x = noise(32, B, N, 3, scale=0.3)
    sched = (1e-3, 1e-4, 0, 4, 0, 25)
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    opt = optax.chain(capture, joptim.make_optimizer(
        joptim.warmup_cosine_schedule(*sched)))
    params = jlion.params["vae"]
    state = joptim.create_train_state(params, opt, 0.0)
    step = jax.jit(jax_vae_step(jvae, opt, as_view(jlion.cfg.to_dict())))
    rng = jax.random.PRNGKey(33)
    new_state, metrics = step(state, jnp.asarray(x), rng,
                              class_label=jnp.asarray(LABELS))
    rng_s, _ = jax.random.split(rng)
    _, _, latent_list = jax.jit(lambda p, xx: jvae.apply(
        {"params": p}, xx, method=JaxVAE.encode,
        rngs={"sample": rng_s}))(params, jnp.asarray(x))
    saved = {k: p.detach().clone() for k, p in vae.named_parameters()}
    try:
        pstep = make_vae_train_step(vae, warmup_cosine_schedule(*sched),
                                    device="cpu")
        got = pstep(torch.from_numpy(x), rho=_rho(latent_list),
                    class_label=torch.from_numpy(LABELS))
        for k in ("loss", "print/loss_0", "print/kl_glb", "msg/kl"):
            np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                       rtol=1e-5, err_msg=k)
        grads = _port_grads(vae)
        assert float(grads["class_embedding.kernel"].abs().sum()) > 0
        _grad_bounds(grads, _flat(new_state.opt_state[0]))
    finally:
        with torch.no_grad():
            for k, p in vae.named_parameters():
                p.copy_(saved[k])
                p.grad = None


# ------------------------------------------------------------- trainers
@pytest.fixture(scope="module")
def two_cates(tmp_path_factory):
    """A PointFlow tree of two categories (airplane, chair), 4 training and
    2 test clouds each."""
    root = tmp_path_factory.mktemp("two_cates")
    rng = np.random.RandomState(1)
    for synset in SYNSETS:
        for split, count in (("train", 4), ("val", 2), ("test", 2)):
            d = root / synset / split
            d.mkdir(parents=True)
            for i in range(count):
                np.save(str(d / f"m{i}.npy"),
                        (rng.randn(2048, 3) * 0.2).astype(np.float32))
    return str(root)


def test_stage1_trainer_on_two_categories_and_checkpoints_both_ways(
        tmp_path, two_cates):
    over = dict(data__cond_on_cat=1, data__nclass=2,
                data__cates="airplane,chair")
    pt = _port_trainer(tmp_path, two_cates, **over)
    labels = [set(b["cate_idx"].tolist()) for b in pt.train_loader]
    assert set().union(*labels) == {0, 1}
    pt.train_epochs()
    assert pt.step == pt.cfg.trainer.epochs * len(pt.train_loader)
    assert all(torch.isfinite(p).all() for p in pt.step_fn.params)
    out = pt.sample(3, generator=torch.Generator().manual_seed(1))
    assert out.shape == (3, 32, 3) and torch.isfinite(out).all()
    # the reconstruction eval reads each test batch's labels
    nll = pt.eval_nll(num_batches=1)
    assert nll and all(np.isfinite(v) for v in nll.values()
                       if np.ndim(v) == 0)

    # lion_tpu's Trainer.save -> the port's resume, and back
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(pt.vae))
    assert "class_embedding" in params
    jcfg = trainer_cfg(jax_default_cfg(), str(tmp_path), two_cates)
    for key, value in over.items():
        node, leaf = key.split("__")
        setattr(getattr(jcfg, node), leaf, value)
    jt = _jax_trainer(jcfg, _Args(str(tmp_path), two_cates),
                      _jax_state(params, 1), epoch=1, step=3)
    jt.save(tag="from_jax")
    assert pt.resume(os.path.join(pt.ckpt_dir, "from_jax.npz"))
    _assert_trainer_holds(pt, jt.state, 1, 3)
    pt.save(tag="from_port")
    from lion_tpu.ckpt import io as jio
    trees, meta = jio.load_checkpoint(os.path.join(pt.ckpt_dir,
                                                   "from_port.npz"))
    other = _jax_trainer(jcfg, _Args(str(tmp_path), two_cates),
                         _jax_state(params, 2), epoch=0, step=0)
    other.load_state_trees(trees, meta)
    for a, b in zip(jax.tree_util.tree_leaves(other.state),
                    jax.tree_util.tree_leaves(jt.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pt.writer.close()


def test_two_prior_trainer_on_two_categories(tmp_path, two_cates):
    cfg = trainer_cfg(get_default_cfg(), str(tmp_path), two_cates)
    cfg.data.cond_on_cat, cfg.data.nclass = 1, 2
    cfg.data.cates = "airplane,chair"
    cfg.ddpm.num_steps = 5
    cfg.sde.num_channels_dae = 16
    cfg.sde.num_cell_per_scale_dae = 1
    cfg.sde.embedding_dim = 8
    cfg.sde.warmup_epochs = 0
    cfg.viz.val_freq = 1
    pt = TwoPrior(cfg, _Args(str(tmp_path), two_cates), device="cpu")
    seen = []
    conditions = pt.conditions
    pt.conditions = lambda batch: seen.append(
        batch["cate_idx"].tolist()) or conditions(batch)
    pt.train_epochs()
    step_fn = pt.step_fn
    labels = sum(seen, [])
    assert pt.step == len(seen) == cfg.trainer.epochs * 2
    assert labels.count(0) == labels.count(1) == 4 * cfg.trainer.epochs
    assert all(torch.isfinite(p).all() for p in step_fn.params)
    # sampling conditions on arange(n) % nclass
    calls = []
    sample = pt.lion.sample

    def record(n, gen, **kw):
        calls.append(kw["class_label"].tolist())
        return sample(n, gen, **kw)
    pt.lion.sample = record
    pts = pt.sample(3, generator=torch.Generator().manual_seed(2))
    del pt.lion.sample
    assert calls == [[0, 1, 0]]
    assert pts.shape == (3, 32, 3) and torch.isfinite(pts).all()
    pt.writer.close()
