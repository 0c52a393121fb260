"""The port's stage-2 trainers against lion_tpu's on the CPU: the two-prior
and the single-prior trainer (`.npz` checkpoints both ways, one
`train_iter` after a resume on lion_tpu's draws, the VAE hand-over from a
stage-1 checkpoint), `eval_sample`'s scoring and files, sampling from the
EMA, the interpolation module and trainers, the registry, the defaults and
the refusals.

The setting is tests/test_trainers.py's tiny one (32 points, a two-stage
U-Net, a 16-wide global prior, 5 DDPM steps) through
test_torch_port_trainer.py's `trainer_cfg` (the style encoder shrunk as
there), with dropout 0 where the packages are compared (their random bits
differ). Each lion_tpu trainer is built once for the module.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.ckpt import io as jio
from lion_tpu.ckpt import torch_import as jti
from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import get_trainer as jax_get_trainer
from lion_tpu.trainers import interpolate as jinterp
from lion_tpu.trainers.base import BaseTrainer as JaxBaseTrainer
from lion_tpu.trainers.train_2prior import NO_REFS as JAX_NO_REFS
from lion_tpu.trainers.train_2prior import Trainer as JaxTwoPrior
from lion_tpu.trainers.train_prior import Trainer as JaxSinglePrior

from lion_tpu_torch.ckpt import io
from lion_tpu_torch.ckpt.torch_import import load_lion_checkpoint
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models import LION
from lion_tpu_torch.trainers import TRAINERS, get_trainer
from lion_tpu_torch.trainers import interpolate
from lion_tpu_torch.trainers.hvae_trainer import Trainer as Stage1
from lion_tpu_torch.trainers.interpolate import (EncodeInterpTrainer,
                                                 InterpolateLatentTrainer)
from lion_tpu_torch.trainers.train_2prior import NO_REFS
from lion_tpu_torch.trainers.train_2prior import Trainer as TwoPrior
from lion_tpu_torch.trainers.train_prior import Trainer as SinglePrior

from test_torch_port_sample import (one_torch_thread,  # noqa: F401
                                    ROOT, to_jax_tree)
from test_torch_port_train import _flat, _grad_bounds, _rho, unet_dtypes
from test_torch_port_trainer import (_Args, _jax_state, _jax_trainer,
                                     data_root, trainer_cfg)  # noqa: F401

EMA_DECAY = 0.9
LR = 3e-4


def stage2_cfg(cfg, save_dir, data_root, **over):
    """The tiny stage-2 setting: test_torch_port_trainer's `trainer_cfg`
    (tests/test_trainers.py's tiny shapes, style encoder shrunk) with
    tiny_train_cfg's priors and chain, no dropout, the EMA at 0.9, a
    constant learning rate and 4 validation samples. `over` sets
    "node__leaf" keys."""
    cfg = trainer_cfg(cfg, save_dir, data_root)
    cfg.latent_pts.pvd_mse_loss = 1
    cfg.ddpm.num_steps = 5
    cfg.sde.num_channels_dae = 16
    cfg.sde.num_cell_per_scale_dae = 1
    cfg.sde.embedding_dim = 8
    cfg.sde.epochs = 2
    cfg.sde.warmup_epochs = 0
    cfg.sde.dropout = 0.0
    cfg.sde.ema_decay = EMA_DECAY
    cfg.sde.learning_rate_dae = cfg.sde.learning_rate_min_dae = LR
    cfg.num_val_samples = 4
    for key, value in over.items():
        node, leaf = key.split("__")
        setattr(getattr(cfg, node), leaf, value)
    return cfg


def _port(cls, tmp_path, data_root, **over):
    d = str(tmp_path)
    return cls(stage2_cfg(get_default_cfg(), d, data_root, **over),
               _Args(d, data_root), device="cpu")


def _jax(cls, save_dir, data_root, **over):
    return cls(stage2_cfg(jax_default_cfg(), save_dir, data_root, **over),
               _Args(save_dir, data_root))


@pytest.fixture(scope="module")
def jax_two(tmp_path_factory, data_root):
    """lion_tpu's two-prior Trainer, with its state and rng at build."""
    jt = _jax(JaxTwoPrior, str(tmp_path_factory.mktemp("jax_two")),
              data_root)
    return {"trainer": jt, "state": jt.state, "rng": jt.rng}


@pytest.fixture(scope="module")
def jax_single(tmp_path_factory, data_root):
    jt = _jax(JaxSinglePrior, str(tmp_path_factory.mktemp("jax_single")),
              data_root)
    return {"trainer": jt, "state": jt.state, "rng": jt.rng}


def _fresh(jax_fixture):
    """The module's lion_tpu trainer, back at the state and rng of its
    build, epoch and step 0."""
    jt = jax_fixture["trainer"]
    jt.state, jt.rng, jt.epoch, jt.step = (jax_fixture["state"],
                                           jax_fixture["rng"], 0, 0)
    return jt


def _named(tree, prefix=""):
    return {prefix + k: v for k, v in _flat(tree).items()}


# -------------------------------------------------------- registry etc.
def test_get_trainer_maps_the_five_names_as_lion_tpu():
    names = ["trainers.hvae_trainer", "trainers.train_2prior",
             "trainers.train_prior", "trainers.interpolate_latent",
             "trainers.encode_interp_interp"]
    # beside lion_tpu's five, the port's DiT-3D trainer
    assert sorted(TRAINERS) == sorted(names + ["trainers.dit3d_trainer"])
    want = {"trainers.hvae_trainer": Stage1,
            "trainers.train_2prior": TwoPrior,
            "trainers.train_prior": SinglePrior,
            "trainers.interpolate_latent": InterpolateLatentTrainer,
            "trainers.encode_interp_interp": EncodeInterpTrainer}
    for name in names:
        assert get_trainer(name) is want[name]
        assert get_trainer(name).__name__ == jax_get_trainer(name).__name__
    for other in ("trainers.ddpm_trainer", "train_2prior", ""):
        with pytest.raises(KeyError, match="unknown trainer type"):
            get_trainer(other)


@pytest.mark.parametrize("name", sorted(set(TRAINERS)
                                        - {"trainers.hvae_trainer"}))
def test_stage2_trainers_default_to_the_card(tmp_path, data_root, name):
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without CUDA")
    cfg = stage2_cfg(get_default_cfg(), str(tmp_path), data_root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_trainer(name)(cfg, _Args(str(tmp_path), data_root))


@pytest.mark.parametrize("cls", [TwoPrior, SinglePrior,
                                 InterpolateLatentTrainer,
                                 EncodeInterpTrainer])
@pytest.mark.parametrize("key,value,item", [
    ("data__cond_on_cat", True, "item J"),
    ("clipforge__enable", True, "item J")])
def test_stage2_trainers_refuse_what_is_not_ported(tmp_path, data_root, cls,
                                                   key, value, item):
    """Class and CLIP conditioning (once refused as item J2): a trainer
    that cannot take them refuses at build. The single prior refuses
    data.cond_on_cat (a two-prior feature, as lion_tpu asserts); the
    interpolation trainers refuse both (lion_tpu's interpolations give the
    priors no label or feature); every trainer refuses clipforge.enable
    without the render views of data.clip_forge_enable. The two-prior
    trainer builds under cond_on_cat, with the class embedding and the
    local prior's wider condition."""
    if cls is TwoPrior and key == "data__cond_on_cat":
        pt = _port(cls, tmp_path, data_root, **{key: value})
        cfg = pt.cfg
        assert tuple(pt.vae.class_embedding.kernel.shape) == (
            cfg.data.nclass, cfg.tpu.cls_emb_dim)
        widths = {tuple(v.shape)[0] for k, v in
                  pt.lion.local_prior.state_dict().items()
                  if k.endswith("emd.kernel")}
        assert widths == {cfg.latent_pts.style_dim + cfg.tpu.cls_emb_dim}
        return
    interp = cls in (InterpolateLatentTrainer, EncodeInterpTrainer)
    match = "no class label or CLIP" if interp else (
        "train_2prior" if key == "data__cond_on_cat" else
        "data.clip_forge_enable")
    with pytest.raises((NotImplementedError, ValueError), match=match):
        _port(cls, tmp_path, data_root, **{key: value})


@pytest.mark.parametrize("cls", [TwoPrior, SinglePrior,
                                 InterpolateLatentTrainer,
                                 EncodeInterpTrainer])
@pytest.mark.parametrize("key", ["tpu__bf16", "sde__autocast_train"])
def test_stage2_trainers_build_bf16_under_the_key(tmp_path, data_root, cls,
                                                  key):
    """bf16 training (once refused): under either key each stage-2 trainer
    sets tpu.bf16 (autocast_train maps onto it, as lion_tpu's BaseTrainer
    does), builds the VAE's U-Nets and the local prior in bf16, and keeps
    its parameters, Adam and EMA in float32."""
    pt = _port(cls, tmp_path, data_root, **{key: True})
    assert pt.cfg.tpu.bf16
    nets = [pt.vae.encoder, pt.vae.decoder] + (
        [pt.lion.local_prior] if hasattr(pt, "lion") else [])
    assert unet_dtypes(*nets) == {torch.bfloat16}
    step = pt.step_fn
    assert all(p.dtype == torch.float32
               for p in step.params + step.ema.shadow)


def test_ode_interpolation_and_vis_refuse(tmp_path, data_root, monkeypatch):
    """The visualizations refuse at build when matplotlib cannot be
    imported (once refused outright, item J1); the PF-ODE interpolation,
    which refused before continuous diffusion was ported, samples (its
    parity is test_torch_port_weighted.py's)."""
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            _port(TwoPrior, tmp_path, data_root, viz__viz_freq=400)
    pt = _port(TwoPrior, tmp_path, data_root)
    out = interpolate.generate_interpolation(
        pt.lion, 2, torch.Generator().manual_seed(0), use_ode=True,
        ode_eps=1e-2, ode_solver_tol=1e-1)
    assert out["nfe"] > 0 and torch.isfinite(out["points"]).all()


@pytest.mark.parametrize("cls", [TwoPrior, SinglePrior,
                                 InterpolateLatentTrainer,
                                 EncodeInterpTrainer])
def test_stage2_trainers_draw_the_sample_grid(tmp_path, data_root, cls):
    """viz.viz_freq != 0 (once refused): each stage-2 trainer builds and
    draws its sample grid through its own `sample` (min(num_val_samples,
    8) shapes) into images/ and metrics.jsonl."""
    pt = _port(cls, tmp_path, data_root, viz__viz_freq=400,
               viz__vis_sample_ddim_step=2 if cls is TwoPrior else 0)
    pt.vis_sample(5)
    pt.writer.close()
    assert os.listdir(tmp_path / "images") == ["vis_sample_5.png"]
    with open(tmp_path / "metrics.jsonl") as f:
        assert [(r["tag"], r["step"]) for r in map(json.loads, f)] == [
            ("vis/sample", 5)]


# ------------------------------------------------------- VAE hand-over
@pytest.mark.parametrize("source", ["lion_tpu_npz", "port_npz", "pt"])
def test_vae_handover_from_a_stage1_checkpoint(tmp_path, data_root, source):
    """sde.vae_checkpoint set to a lion_tpu stage-1 Trainer's .npz, the
    port's stage-1 Trainer's .npz, or a .pt holding the reference layout's
    state_dict under "model": the stage-2 VAE equals the source."""
    d = str(tmp_path)
    stage1 = Stage1(trainer_cfg(get_default_cfg(), d, data_root),
                    _Args(d, data_root), device="cpu")
    with torch.no_grad():   # weights unlike the stage-2 trainer's draw
        for p in stage1.vae.parameters():
            p.add_(0.25)
    tree = to_jax_tree(stage1.vae)
    if source == "lion_tpu_npz":
        jt = _jax_trainer(trainer_cfg(jax_default_cfg(), d, data_root),
                          _Args(d, data_root), _jax_state(
                              jax.tree_util.tree_map(jnp.asarray, tree), 1),
                          epoch=1, step=3)
        jt.save(tag="stage1")
        path = os.path.join(jt.ckpt_dir, "stage1.npz")
    elif source == "port_npz":
        stage1.save(tag="stage1")
        path = os.path.join(stage1.ckpt_dir, "stage1.npz")
    else:
        path = os.path.join(d, "vae.pt")
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in jti.export_state_dict(
                                  tree, "vae").items()}}, path)
    pt = _port(TwoPrior, tmp_path, data_root, sde__vae_checkpoint=path)
    got = to_jax_tree(pt.vae)
    for k, v in io.flatten_tree(tree).items():
        np.testing.assert_array_equal(io.flatten_tree(got)[k], v,
                                      err_msg=str(k))
    assert pt.lion.vae is pt.vae


# --------------------------------------------------------- checkpoints
def _random_state(state, seed):
    """`state` with Adam's moments, the counts and the EMA filled from a
    seed (the lion_tpu trainer's optimizer), the step at 3."""
    leaves, treedef = jax.tree_util.tree_flatten(state.opt_state)
    rs = np.random.RandomState(seed)
    leaves = [jnp.asarray(np.int32(3)) if leaf.ndim == 0 else
              jnp.asarray(rs.rand(*leaf.shape).astype(np.float32))
              for leaf in leaves]
    ema = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape).astype(np.float32)),
        state.params)
    return state.replace(
        step=jnp.asarray(3, jnp.int32), ema_params=ema,
        opt_state=jax.tree_util.tree_unflatten(treedef, leaves))


def _assert_holds(pt, state, vae_params, epoch, step):
    """The port trainer holds lion_tpu's state: parameters, EMA, Adam's
    moments and count, the VAE, epoch and step, all exactly."""
    want_p, want_e = _named(state.params), _named(state.ema_params)
    adam = state.opt_state[0][0]
    want_mu, want_nu = _named(adam.mu), _named(adam.nu)
    mu, nu = pt.step_fn.optimizer.moments()
    assert len(pt.param_names) == len(want_p)
    for i, n in enumerate(pt.param_names):
        for got, want in ((pt.step_fn.params[i].detach(), want_p[n]),
                          (pt.step_fn.ema.shadow[i], want_e[n]),
                          (mu[i], want_mu[n]), (nu[i], want_nu[n])):
            assert torch.equal(got, want), n
    for k, v in _flat(vae_params).items():
        assert torch.equal(pt.vae.state_dict()[k], v), k
    assert pt.step_fn.optimizer.count == int(adam.count) == step
    assert (pt.epoch, pt.step) == (epoch, step)


@pytest.mark.parametrize("which", ["two_prior", "single_prior"])
def test_checkpoints_cross_both_ways_with_lion_tpu(tmp_path, data_root,
                                                   jax_two, jax_single,
                                                   which):
    fixture, cls = ((jax_two, TwoPrior) if which == "two_prior"
                    else (jax_single, SinglePrior))
    jt = _fresh(fixture)
    jt.state = _random_state(fixture["state"], 1)
    jt.epoch, jt.step = 1, 3
    # lion_tpu's Trainer.save -> the port's Trainer.resume
    jt.save(tag="from_jax")
    jax_path = os.path.join(jt.ckpt_dir, "from_jax.npz")
    pt = _port(cls, tmp_path, data_root)
    assert pt.resume(jax_path)
    _assert_holds(pt, jt.state, jt.vae_params, 1, 3)

    # the port's Trainer.save -> lion_tpu's load_checkpoint and Trainer
    pt.save(tag="from_port")
    port_path = os.path.join(pt.ckpt_dir, "from_port.npz")
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want_state, want_vae = jt.state, jt.vae_params
    jt = _fresh(fixture)
    trees, meta = jio.load_checkpoint(port_path)
    jt.load_state_trees(trees, meta)
    for a, b in zip(jax.tree_util.tree_leaves(jt.state),
                    jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(jt.vae_params),
                    jax.tree_util.tree_leaves(want_vae)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _fresh(fixture)


# --------------------------------------------------------- train_iter
def _encode_jax(jt, x, rng):
    return jax.jit(lambda p, xx, k: jt.vae.apply(
        {"params": p}, xx, method=JaxVAE.encode, rngs={"sample": k}))(
        jt.vae_params, jnp.asarray(x), rng)


def _assert_step_matches(pt, before, state, lr):
    """PR 13's step bounds on lion_tpu's updated state. Adam's first step
    moves each parameter by ~lr * sign(g); where the gradient is rounding
    noise its sign may differ and the update by up to 2 lr, elsewhere it
    is held to lr / 100. The EMA moves (1 - decay) of the update and is
    held in proportion. lion_tpu's gradient is its first moment over
    (1 - beta1) (the moments start at 0)."""
    adam = state.opt_state[0][0]
    beta1 = float(pt.cfg.trainer.opt.beta1)
    want_g = {k: v / (1.0 - beta1) for k, v in _named(adam.mu).items()}
    got_g = {n: p.grad.detach().clone()
             for n, p in zip(pt.param_names, pt.step_fn.params)}
    _grad_bounds(got_g, want_g)
    want_p, want_e = _named(state.params), _named(state.ema_params)
    g_norm = float(torch.cat([g.reshape(-1) for g in want_g.values()])
                   .norm())
    for i, k in enumerate(pt.param_names):
        d = (pt.step_fn.params[i].detach() - want_p[k]).abs()
        assert float(d.max()) <= 2.0 * lr + 1e-6, k
        off = d > 1e-2 * lr
        noise_g = torch.where(off, want_g[k].abs(), 0.0)
        assert float(noise_g.max()) <= 1e-6 * g_norm, k
        moved = ((pt.step_fn.ema.shadow[i] - before[k])
                 - (want_e[k] - before[k])).abs()
        tol = (1.0 - EMA_DECAY) * torch.where(off, 2.0 * lr, 1e-2 * lr) \
            + 1e-7
        assert bool((moved <= tol).all()), (k, float(moved.max()))
    assert pt.step_fn.optimizer.count == int(state.step) == 1


@pytest.mark.parametrize("which", ["two_prior", "single_prior"])
def test_train_iter_after_resume_matches_lion_tpu(tmp_path, data_root,
                                                  jax_two, jax_single,
                                                  which):
    """lion_tpu's trainer at its build state is saved and resumed by the
    port's; both take one train_iter on the same batch, the port on the
    draws lion_tpu's key makes (lion_tpu/trainers/steps.py:137,
    train_prior.py:107)."""
    fixture, cls = ((jax_two, TwoPrior) if which == "two_prior"
                    else (jax_single, SinglePrior))
    jt = _fresh(fixture)
    jt.save(tag="init")
    pt = _port(cls, tmp_path, data_root)
    assert pt.resume(os.path.join(jt.ckpt_dir, "init.npz"))
    before = _named(jt.state.params)
    batch = next(iter(pt.train_loader))
    x = np.asarray(batch["tr_points"], np.float32)
    b = x.shape[0]
    _, sub = jax.random.split(jt.rng)
    if which == "two_prior":
        rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(sub, 5)
    else:
        rng_enc, rng_t, rng_n, _ = jax.random.split(sub, 4)
    eps, _, latent_list = _encode_jax(jt, x, rng_enc)
    t = (jax.random.uniform(rng_t, (b,)) * pt.cfg.ddpm.num_steps
         ).astype(jnp.int32) + 1
    style = pt.cfg.latent_pts.style_dim
    if which == "two_prior":
        noise = (torch.from_numpy(np.array(
                     jax.random.normal(rng_n0, (b, style)))),
                 torch.from_numpy(np.array(jax.random.normal(
                     rng_n1, (b, eps.shape[1] - style)))))
    else:
        noise = torch.from_numpy(np.array(
            jax.random.normal(rng_n, eps.shape)))
    want = jt.train_iter(batch, 0)
    got = pt.train_iter(batch, 0, rho=_rho(latent_list),
                        timestep=torch.from_numpy(np.array(t)),
                        noise=noise)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _assert_step_matches(pt, before, jt.state, LR)
    _fresh(fixture)


# ----------------------------------------------------------- eval_sample
def _stub_sample(clouds, seen):
    """A `sample` that hands out the rows of `clouds` in order and records
    its generator's seed (port) or key (lion_tpu)."""
    def sample(n, generator=None, rng=None, ddim_step=0, **kw):
        seen.append((generator.initial_seed() if generator is not None
                     else np.asarray(rng).tolist(), ddim_step))
        out = clouds[sample.next:sample.next + n]
        sample.next += n
        return out
    sample.next = 0
    return sample


@pytest.mark.parametrize("norm_box", [True, False])
def test_eval_sample_matches_lion_tpu(tmp_path, data_root, norm_box):
    """Both trainers score the same generated clouds (their `sample`
    stubbed in this test) against the split: the results within 1e-5, the
    CSV rows and eval_out.txt lines equal, samples_<step>.pt equal; the
    shape-box branch and the de-normalized one (recenter off, global
    normalization)."""
    over = {"data__recenter_per_shape": False,
            "data__normalize_global": True} if not norm_box else {}
    over["data__batch_size_test"] = 2
    dirs = {k: str(tmp_path / k) for k in ("port", "jax")}
    cfg, jcfg = (stage2_cfg(fn(), dirs[k], data_root, **over)
                 for fn, k in ((get_default_cfg, "port"),
                               (jax_default_cfg, "jax")))
    cfg.eval_ddim_step = jcfg.eval_ddim_step = 3
    pt = TwoPrior(cfg, _Args(dirs["port"], data_root), device="cpu")
    # lion_tpu's trainer without its models: eval_sample reads the data,
    # the writer and `sample`
    jt = JaxTwoPrior.__new__(JaxTwoPrior)
    JaxBaseTrainer.__init__(jt, jcfg, _Args(dirs["jax"], data_root))
    jt.build_data()
    pt.epoch = jt.epoch = 1200
    clouds = (np.random.RandomState(7).randn(4, 32, 3) * 0.3).astype(
        np.float32)
    seen_p, seen_j = [], []
    pt.sample = _stub_sample(torch.from_numpy(clouds), seen_p)
    jt.sample = _stub_sample(jnp.asarray(clouds), seen_j)
    got = pt.eval_sample(2000, num_gen=4, metric2="EMD")
    want = jt.eval_sample(2000, num_gen=4, metric2="EMD")
    # batches of data.batch_size_test (2), each from seed + i
    seed = cfg.trainer.seed
    assert seen_p == [(seed, 3), (seed + 2, 3)]
    assert seen_j == [(np.asarray(jax.random.PRNGKey(s)).tolist(), 3)
                      for s in (seed, seed + 2)]
    assert set(got) == set(want)
    assert "1-NN-EMD-acc" in got and "jsd" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    for name in ("eval_out.txt", os.path.join("results", "eval_out.csv")):
        with open(os.path.join(dirs["port"], name)) as a, \
                open(os.path.join(dirs["jax"], name)) as b:
            assert a.read() == b.read(), name
    saved = [torch.load(os.path.join(d, "samples_2000.pt"))
             for d in (dirs["port"], dirs["jax"])]
    assert torch.equal(saved[0], saved[1])
    assert torch.equal(saved[0], torch.from_numpy(clouds))


def test_eval_sample_without_references(tmp_path, data_root):
    """No test split and no reference .pt: NO_REFS, as lion_tpu's; run_eval
    then logs the samples' mean |x| and tracks no score."""
    d = str(tmp_path)
    pt = _port(TwoPrior, tmp_path, data_root)
    jt = JaxTwoPrior.__new__(JaxTwoPrior)
    JaxBaseTrainer.__init__(jt, stage2_cfg(jax_default_cfg(), d, data_root),
                            _Args(d, data_root))
    pt.test_loader = jt.test_loader = None
    clouds = np.zeros((4, 32, 3), np.float32)
    pt.sample = _stub_sample(torch.from_numpy(clouds), [])
    jt.sample = _stub_sample(jnp.asarray(clouds), [])
    assert pt.eval_sample(0, num_gen=4) is NO_REFS
    assert jt.eval_sample(0, num_gen=4) is JAX_NO_REFS
    del pt.sample
    assert pt.run_eval() is None
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert "eval/sample_abs_mean" in f.read()


# --------------------------------------------------------------- sample
def test_sample_reads_the_ema_and_chunks_bit_for_bit(tmp_path, data_root):
    """The chunked chain equals the whole one bit for bit under
    given_noise, and is what the trainer runs from 500 DDPM steps up
    (lion_tpu/trainers/train_2prior.py:243-256); it samples from the EMA,
    not the trained parameters, and leaves those as they were."""
    pt = _port(TwoPrior, tmp_path, data_root, ddpm__num_steps=8)
    with torch.no_grad():
        for e in pt.step_fn.ema.shadow:
            e.mul_(0.5)
    trained = [p.detach().clone() for p in pt.step_fn.params]
    rs = np.random.RandomState(3)
    t, b = 8, 2
    given = tuple((torch.from_numpy(rs.randn(b, d).astype(np.float32)),
                   torch.from_numpy(rs.randn(t, b, d).astype(np.float32)))
                  for d in (pt.lion.style_dim, pt.lion.local_dim))
    with pt.as_lion() as lion:
        chunked = lion.sample_chunked(b, chunks=4, given_noise=given)
    with pt.step_fn.ema.swapped():
        whole = pt.lion.sample(b, given_noise=given)
    for k in ("z_global", "z_local", "points"):
        assert torch.equal(chunked[k], whole[k]), k
    assert torch.equal(pt.sample(b, given_noise=given), whole["points"])
    assert all(torch.equal(p, q) for p, q in zip(pt.step_fn.params,
                                                 trained))
    # the branch: chunks of 4 from 500 steps up, with the trainer's draws
    calls = []
    pt.lion.sample_chunked = lambda n, gen, chunks, given_noise: \
        calls.append((n, chunks, given_noise)) or {"points": "chunked"}
    pt.lion.diffusion.num_steps = 500
    assert pt.sample(b, given_noise=given) == "chunked"
    assert calls == [(b, 4, given)]
    del pt.lion.sample_chunked
    pt.lion.diffusion.num_steps = t
    # DDIM from the EMA differs from DDIM from the trained values, and
    # equals it once the EMA is copied in
    gen = lambda: torch.Generator().manual_seed(4)
    ema = pt.sample(b, gen(), ddim_step=3)
    assert not torch.equal(ema, pt.sample(b, gen(), use_ema=False,
                                          ddim_step=3))
    with torch.no_grad():
        for p, e in zip(pt.step_fn.params, pt.step_fn.ema.shadow):
            p.copy_(e)
    assert torch.equal(ema, pt.sample(b, gen(), use_ema=False, ddim_step=3))


def _chain_noise(rng, steps, shape):
    """The per-step draws of lion_tpu's scans from `rng` (first split
    kept), indexed by the step: (T, *shape)."""
    out = np.zeros((steps,) + shape, np.float32)
    for t in range(steps - 1, -1, -1):
        rng, sub = jax.random.split(rng)
        out[t] = np.asarray(jax.random.normal(sub, shape))
    return torch.from_numpy(out)


class _DecodeRecorder:
    """Stands in for lion_tpu's VAE module in a LION view: applies it and
    keeps the latents that VAE.sample decodes."""

    def __init__(self, vae):
        self.vae, self.decoded = vae, None

    def apply(self, variables, *args, **kwargs):
        if kwargs.get("method") is JaxVAE.sample:
            self.decoded = kwargs["decomposed_eps"]
        return self.vae.apply(variables, *args, **kwargs)


def test_single_prior_sample_is_the_chain_over_eps(jax_single, tmp_path,
                                                  data_root):
    """The port's single-prior `sample` against lion_tpu's
    (train_prior.py:155-175) from the same EMA prior and VAE, on the draws
    lion_tpu's key makes: rng_s's chain over eps (its initial draw split
    off first), then the split into the two latents and the decode."""
    jt = _fresh(jax_single)
    jt.save(tag="sample")
    pt = _port(SinglePrior, tmp_path, data_root)
    assert pt.resume(os.path.join(jt.ckpt_dir, "sample.npz"))
    assert pt.eps_dim == 128 + 32 * 4
    n, rng = 2, jax.random.PRNGKey(6)
    jt.vae = recorder = _DecodeRecorder(jt.vae)
    try:   # one compiled program instead of op-by-op dispatch
        want, *want_eps = jax.jit(
            lambda r: (jt.sample(n, r), *recorder.decoded))(rng)
    finally:
        jt.vae = recorder.vae
    rng_s, _ = jax.random.split(rng)
    chain, init_rng = jax.random.split(rng_s)
    shape = (n, pt.eps_dim)
    init = torch.from_numpy(np.array(jax.random.normal(init_rng, shape)))
    steps = _chain_noise(chain, pt.cfg.ddpm.num_steps, shape)
    decode, got_eps = pt.vae.sample, []
    pt.vae.sample = lambda m, eps: got_eps.append(eps) or decode(m, eps)
    got = pt.sample(n, given_noise=(init, steps))
    assert got.shape == (n, 32, 3)
    # fp32 through 5 steps of the prior and a decode, sums in other orders
    for g, w, k in zip([*got_eps[0], got], [*want_eps, want],
                       ("z_global", "z_local", "points")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# -------------------------------------------------------- the whole loop
def test_two_prior_trainer_trains_scores_resumes_and_exports(tmp_path,
                                                             data_root):
    pt = _port(TwoPrior, tmp_path, data_root, sde__dropout=0.1,
               ddpm__dropout=0.1)
    params0 = [p.detach().clone() for p in pt.step_fn.params]
    pt.train_epochs()
    assert (pt.epoch, pt.step) == (1, 4)            # 2 epochs x 2 batches
    assert {"final.npz", "best_eval.npz"} <= set(os.listdir(pt.ckpt_dir))
    assert 0 <= pt.best_eval_score <= 1
    assert all(torch.isfinite(p).all() for p in pt.step_fn.params)
    moved = [not torch.equal(p, q) for p, q in zip(pt.step_fn.params,
                                                   params0)]
    assert sum(moved) > 0.9 * len(moved)
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    # the step's metrics under the loop's "train/" prefix, as in lion_tpu
    assert {"train/loss", "train/train/p_loss_0", "train/train/p_loss_1",
            "test/1NN_CD", "test/MMD_CD", "test/JSD",
            "eval/best_score"} <= tags

    again = _port(TwoPrior, tmp_path, data_root)
    assert again.resume(os.path.join(pt.ckpt_dir, "final.npz"))
    for a, b in ((again.step_fn.params, pt.step_fn.params),
                 (again.step_fn.ema.shadow, pt.step_fn.ema.shadow),
                 *zip(again.step_fn.optimizer.moments(),
                      pt.step_fn.optimizer.moments())):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert again.step_fn.optimizer.count == 4

    results = again.eval_sample(again.step, num_gen=4)
    assert {"lgan_mmd-EMD", "1-NN-EMD-acc", "jsd"} <= set(results)
    assert np.isfinite(list(results.values())).all()
    assert os.path.exists(os.path.join(str(tmp_path), "samples_4.pt"))

    # the release-format export holds the EMA priors, and loads into a
    # LION bit for bit
    path = str(tmp_path / "prior.pt")
    again.export_torch(path)
    ckpt = torch.load(path, weights_only=True)
    assert (ckpt["epoch"], ckpt["global_step"]) == (1, 4)
    lion = LION(again.cfg, device="cpu").load_jax_params(
        load_lion_checkpoint(path, again.cfg))
    names = again.param_names
    for i, n in enumerate(names):
        assert torch.equal(lion.state_dict()[n], again.step_fn.ema.shadow[i])
    for k, v in again.vae.state_dict().items():
        assert torch.equal(lion.state_dict()[f"vae.{k}"], v)


def test_single_prior_trainer_trains_and_resumes(tmp_path, data_root):
    pt = _port(SinglePrior, tmp_path, data_root, sde__dropout=0.1,
               sde__mixed_prediction=True)
    params0 = [p.detach().clone() for p in pt.step_fn.params]
    pt.train_epochs()
    assert pt.step == 4 and all(torch.isfinite(p).all()
                                for p in pt.step_fn.params)
    assert not all(torch.equal(p, q) for p, q in zip(pt.step_fn.params,
                                                     params0))
    again = _port(SinglePrior, tmp_path, data_root,
                  sde__mixed_prediction=True)
    again.resume(os.path.join(pt.ckpt_dir, "final.npz"))
    for a, b in ((again.step_fn.params, pt.step_fn.params),
                 (again.step_fn.ema.shadow, pt.step_fn.ema.shadow)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    out = again.sample(2)
    assert out.shape == (2, 32, 3) and torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="two-prior"):
        again.export_torch(str(tmp_path / "x.pt"))


# -------------------------------------------------------- interpolation
@pytest.mark.parametrize("mode", ["interpolate", "linear_interpolate",
                                  "freeze"])
def test_noise_modes_match_lion_tpu(mode):
    noise = np.random.RandomState(5).randn(7, 9).astype(np.float32)
    got = interpolate.MODES[mode](torch.from_numpy(noise))
    want = jinterp._MODES[mode](jnp.asarray(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), noise[0])
    if mode != "freeze":
        np.testing.assert_array_equal(got[-1].numpy(), noise[-1])


def _interp_pair(jax_two, tmp_path, data_root):
    """lion_tpu's LION view of its two-prior trainer at build and the
    port's trainer resumed from its checkpoint: the same tiny models."""
    jt = _fresh(jax_two)
    jt.save(tag="interp")
    pt = _port(TwoPrior, tmp_path, data_root)
    assert pt.resume(os.path.join(jt.ckpt_dir, "interp.npz"))
    return jt.as_lion(use_ema=False), pt


def test_generate_interpolation_matches_lion_tpu(jax_two, tmp_path,
                                                 data_root):
    jlion, pt = _interp_pair(jax_two, tmp_path, data_root)
    n, rng = 4, jax.random.PRNGKey(8)
    # one compiled program instead of op-by-op dispatch
    want = jax.jit(lambda r: jinterp.generate_interpolation(
        jlion, n, r, use_ode=False))(rng)
    rng_g, rng_l, _ = jax.random.split(rng, 3)
    shapes = ((rng_g, (n, jlion.style_dim)), (rng_l, (n, jlion.local_dim)))
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(r, shape)))
                  for r, shape in shapes)
    # run_denoising_diffusion splits off its initial draw first
    steps = pt.lion.diffusion.num_steps
    given = tuple(_chain_noise(jax.random.split(r)[0], steps, shape)
                  for r, shape in shapes)
    with pt.as_lion(use_ema=False) as lion:
        got = interpolate.generate_interpolation(lion, n, noise=noise,
                                                 given_noise=given)
    # fp32 through 5 steps of two priors and a decode, sums in other orders
    for k in ("z_global", "z_local", "points"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert got["points"].shape == (n, 32, 3)


def test_run_from_t_matches_lion_tpu(jax_two, tmp_path, data_root):
    """The reverse chain from t = 3 of 5 on the global prior, under
    lion_tpu's per-step draws."""
    jlion, pt = _interp_pair(jax_two, tmp_path, data_root)
    x = np.random.RandomState(9).randn(3, jlion.style_dim).astype(
        np.float32)
    rng = jax.random.PRNGKey(2)

    def jfn(xx, tt):
        return jlion.global_prior.apply(
            {"params": jlion.params["global_prior"]}, xx,
            tt.astype(jnp.float32))
    want = jinterp._run_from_t(jlion.diffusion, jfn, jnp.asarray(x), 3, rng)
    pt.lion.eval()
    with torch.no_grad():
        got = interpolate._run_from_t(
            pt.lion.diffusion, pt.lion.global_prior, torch.from_numpy(x), 3,
            given_noise=_chain_noise(rng, 3, x.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_posterior_interpolation_follows_its_draws(jax_two, tmp_path,
                                                   data_root):
    """interpolate_posterior against lion_tpu's on the same models, on the
    draws lion_tpu's key makes: rng_e's posterior noises, rng_n's forward
    noise, the global chain's steps from rng_n and the local chain's from
    fold_in(rng_n, 1) (lion_tpu/trainers/interpolate.py:117-184). z_global,
    z_local and the points agree."""
    jlion, pt = _interp_pair(jax_two, tmp_path, data_root)
    jlion.vae = recorder = _DecodeRecorder(jlion.vae)
    rs = np.random.RandomState(10)
    xa, xb = ((rs.randn(32, 3) * 0.3).astype(np.float32) for _ in range(2))
    rows, diffuse_t, rng = 5, 3, jax.random.PRNGKey(11)

    def jfn(a, b, r):   # one compiled program instead of op-by-op dispatch
        out = jinterp.interpolate_posterior(jlion, a, b, rows, r,
                                            diffuse_t=diffuse_t)
        return (out["points"], *recorder.decoded)
    want_p, want_g, want_l = jax.jit(jfn)(xa, xb, rng)
    rng_e, rng_n, _ = jax.random.split(rng, 3)
    eps, _, latent_list = _encode_jax(jax_two["trainer"],
                                      np.stack([xa, xb]), rng_e)
    noise = torch.from_numpy(np.array(jax.random.normal(rng_n, eps.shape)))
    given = (_chain_noise(rng_n, diffuse_t, (rows, jlion.style_dim)),
             _chain_noise(jax.random.fold_in(rng_n, 1), diffuse_t,
                          (rows, jlion.local_dim)))
    with pt.as_lion(use_ema=False) as lion:
        got = interpolate.interpolate_posterior(
            lion, torch.from_numpy(xa), torch.from_numpy(xb), rows,
            diffuse_t=diffuse_t, rho=_rho(latent_list), noise=noise,
            given_noise=given)
    assert got["points"].shape == (rows, 32, 3)
    # fp32 through an encode, 3 steps of two priors and a decode
    for k, w in (("z_global", want_g), ("z_local", want_l),
                 ("points", want_p)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_interpolation_trainers_sample_on_the_cpu(tmp_path, data_root):
    """Both trainers sample finite shapes; without a generator they draw
    from one seeded 0, as lion_tpu's default PRNGKey(0)."""
    it = _port(InterpolateLatentTrainer, tmp_path, data_root)
    out = it.sample(4, torch.Generator().manual_seed(0))
    assert out.shape == (4, 32, 3) and torch.isfinite(out).all()
    assert torch.equal(it.sample(4), out)
    et = _port(EncodeInterpTrainer, tmp_path, data_root)
    ends = et.endpoints()
    first = next(iter(et.test_loader))["tr_points"][:2]
    np.testing.assert_array_equal(ends.numpy(), first)
    out = et.sample(4, torch.Generator().manual_seed(0), diffuse_t=3)
    assert out.shape == (4, 32, 3) and torch.isfinite(out).all()
    assert torch.equal(et.sample(4, diffuse_t=3), out)
    # seeded random endpoints only without a test split
    et.test_loader = None
    again = et.endpoints()
    assert again.shape == (2, 32, 3) and torch.equal(again, et.endpoints())


def test_stage2_modules_import_leaves_jax_out():
    code = ("import sys, lion_tpu_torch.trainers.train_2prior, "
            "lion_tpu_torch.trainers.train_prior, "
            "lion_tpu_torch.trainers.interpolate;"
            "bad = [m for m in ('jax', 'flax', 'optax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
