"""The port's stage-1 trainer and its I/O against the JAX package on the
CPU: the ShapeNet15k loader's batches, the `.npz` checkpoints both ways
(including a lion_tpu stage-1 `Trainer`'s own save resumed by the port's
`Trainer`), the metrics writer, and the port's `Trainer` end to end on a
synthetic PointFlow tree with `device="cpu"`.
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
from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.data import shapenet as jshapenet
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.base import BaseTrainer as JaxBaseTrainer
from lion_tpu.trainers.hvae_trainer import Trainer as JaxTrainer
from lion_tpu.utils.writer import Writer as JaxWriter

from lion_tpu_torch.ckpt import io
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.data import shapenet
from lion_tpu_torch.trainers.hvae_trainer import Trainer
from lion_tpu_torch.utils.writer import Writer

from test_torch_port_sample import (  # noqa: F401
    one_torch_thread, ROOT, to_jax_tree)
from test_torch_port_train import run_in_bf16

SYNSET = "02691156"   # airplane


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Synthetic PointFlow layout: <root>/<synset>/<split>/<mid>.npy."""
    root = tmp_path_factory.mktemp("shapenet")
    rng = np.random.RandomState(0)
    for split, count in [("train", 8), ("val", 4), ("test", 4)]:
        d = root / SYNSET / split
        d.mkdir(parents=True)
        for i in range(count):
            pts = (rng.randn(2048, 3) * 0.2).astype(np.float32)
            np.save(str(d / f"mesh{i}.npy"), pts)
    return str(root)


def trainer_cfg(cfg, save_dir, data_root):
    """tests/test_trainers.py's tiny stage-1 setting, with the style
    encoder shrunk by the size multipliers and the U-Net specs scaled back
    up (as tests/test_torch_port_train.py's train_cfg does), dropout 0,
    the visualizations off and the reconstruction eval every epoch."""
    cfg.data.cates = "airplane"
    cfg.data.data_dir = data_root
    cfg.data.tr_max_sample_points = 32
    cfg.data.te_max_sample_points = 32
    cfg.data.batch_size = 4
    cfg.data.batch_size_test = 4
    cfg.shapelatent.latent_dim = 1
    cfg.shapelatent.encoder_type = "models.latent_points_ada.PointTransPVC"
    cfg.shapelatent.decoder_type = "models.latent_points_ada.LatentPointDecPVC"
    cfg.latent_pts.ada_mlp_init_scale = 0.1
    cfg.latent_pts.skip_weight = 0.01
    cfg.shapelatent.log_sigma_offset = 6.0
    cfg.ddpm.loss_type = "l1_sum"
    cfg.ddpm.dropout = 0.0
    cfg.trainer.epochs = 2
    cfg.trainer.anneal_kl = 1
    cfg.trainer.opt.ema_decay = 0.9
    cfg.viz.log_freq = 1
    cfg.viz.viz_freq = 0
    cfg.viz.save_freq = -1
    cfg.viz.val_freq = 1
    cfg.save_dir = save_dir
    cfg.tpu.sa_blocks = [[[8, 1, 4], [8, 0.2, 4, [8, 16]]],
                         [None, [4, 0.4, 4, [16, 16]]]]
    cfg.tpu.fp_blocks = [[[16, 16], [16, 1, 4]], [[16, 8], [8, 1, 4]]]
    cfg.tpu.ncenter_mult, cfg.tpu.vres_mult = 1 / 32, 1 / 4
    for conv, sa in cfg.tpu.sa_blocks:
        if conv is not None:
            conv[2] *= 4
        sa[0] *= 32
    for _, conv in cfg.tpu.fp_blocks:
        conv[2] *= 4
    return cfg


class _Args:
    def __init__(self, save_dir, data_root):
        self.save_dir = save_dir
        self.data_root = data_root


def _port_trainer(tmp_path, data_root, **over):
    cfg = trainer_cfg(get_default_cfg(), str(tmp_path), data_root)
    for key, value in over.items():
        node, leaf = key.split("__")
        setattr(getattr(cfg, node), leaf, value)
    return Trainer(cfg, _Args(str(tmp_path), data_root), device="cpu")


# ----------------------------------------------------------------- data
def test_loader_batches_equal_lion_tpu_over_two_epochs(tmp_path, data_root):
    got = shapenet.get_data_loaders(
        trainer_cfg(get_default_cfg(), str(tmp_path), data_root).data,
        seed=5)
    want = jshapenet.get_data_loaders(
        trainer_cfg(jax_default_cfg(), str(tmp_path), data_root).data,
        seed=5)
    assert len(got["train_loader"]) == len(want["train_loader"]) == 2
    for name in ("train_loader", "test_loader"):
        for epoch in (0, 1):
            got[name].set_epoch(epoch)
            want[name].set_epoch(epoch)
            pairs = list(zip(got[name], want[name]))
            assert len(pairs) == len(want[name])
            for g, w in pairs:
                assert set(g) == set(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    ds = got["train_loader"].dataset
    assert ds.all_cate_mids == want["train_loader"].dataset.all_cate_mids
    item = ds[0]
    assert item["tr_points"].shape == (32, 3) and item["mean"].shape == (1, 3)


@pytest.mark.parametrize("mode", ["normalize_per_shape", "normalize_global",
                                  "normalize_shape_box"])
def test_dataset_normalizations_equal_lion_tpu(data_root, mode):
    kw = dict(split="train", tr_sample_size=32, recenter_per_shape=False,
              normalize_std_per_axis=True, **{mode: True})
    got = shapenet.ShapeNet15kPointClouds(data_root, ["airplane"], **kw)
    want = jshapenet.ShapeNet15kPointClouds(data_root, ["airplane"], **kw)
    np.testing.assert_array_equal(got.all_points, want.all_points)
    for i in range(len(want)):
        for a, b in zip(got.get_pc_stats(i), want.get_pc_stats(i)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- checkpoints
def _jax_trainer(cfg, args, state, epoch, step):
    """A lion_tpu stage-1 Trainer holding `state`, without its data and
    its flax init: BaseTrainer's set-up, then the state a run would
    hold."""
    jt = JaxTrainer.__new__(JaxTrainer)
    JaxBaseTrainer.__init__(jt, cfg, args)
    jt.state, jt.epoch, jt.step = state, epoch, step
    return jt


def _jax_state(params, seed):
    """A TrainState with Adam's moments, the counts and the EMA filled from
    a seed, in the optimizer the lion_tpu trainer builds."""
    opt = joptim.make_optimizer(joptim.warmup_cosine_schedule(
        1e-4, 1e-4, 0, 2, 0, 2))
    state = joptim.create_train_state(params, opt, 0.9)
    leaves, treedef = jax.tree_util.tree_flatten(state.opt_state)
    rs = np.random.RandomState(seed)
    leaves = [jnp.asarray(np.int32(3)) if leaf.ndim == 0 else
              jnp.asarray(rs.rand(*leaf.shape).astype(np.float32))
              for leaf in leaves]
    ema = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape).astype(np.float32)),
        params)
    return state.replace(
        step=jnp.asarray(3, jnp.int32), ema_params=ema,
        opt_state=jax.tree_util.tree_unflatten(treedef, leaves))


def _assert_trainer_holds(pt, state, epoch, step):
    names = pt.param_names
    flat = lambda tree: {".".join(k): np.asarray(v)
                         for k, v in io.flatten_tree(tree).items()}
    want_p, want_e = flat(state.params), flat(state.ema_params)
    adam = state.opt_state[0][0]
    want_mu, want_nu = flat(adam.mu), flat(adam.nu)
    mu, nu = pt.step_fn.optimizer.moments()
    for i, n in enumerate(names):
        np.testing.assert_array_equal(pt.step_fn.params[i].detach().numpy(),
                                      want_p[n], err_msg=n)
        np.testing.assert_array_equal(pt.step_fn.ema.shadow[i].numpy(),
                                      want_e[n], err_msg=n)
        np.testing.assert_array_equal(mu[i].numpy(), want_mu[n], err_msg=n)
        np.testing.assert_array_equal(nu[i].numpy(), want_nu[n], err_msg=n)
    assert pt.step_fn.optimizer.count == int(adam.count) == step
    assert (pt.epoch, pt.step) == (epoch, step)


def test_checkpoints_cross_both_ways_with_lion_tpu(tmp_path, data_root):
    pt = _port_trainer(tmp_path, data_root)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(pt.vae))
    jcfg = trainer_cfg(jax_default_cfg(), str(tmp_path), data_root)
    jt = _jax_trainer(jcfg, _Args(str(tmp_path), data_root),
                      _jax_state(params, 1), epoch=1, step=3)
    # lion_tpu's Trainer.save -> the port's Trainer.resume
    jt.save(tag="from_jax")
    assert pt.resume(os.path.join(pt.ckpt_dir, "from_jax.npz"))
    _assert_trainer_holds(pt, jt.state, 1, 3)

    # the port's Trainer.save -> lion_tpu's load_checkpoint and Trainer
    pt.save(tag="from_port")
    with np.load(os.path.join(pt.ckpt_dir, "from_jax.npz")) as a, \
            np.load(os.path.join(pt.ckpt_dir, "from_port.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    trees, meta = jio.load_checkpoint(os.path.join(pt.ckpt_dir,
                                                   "from_port.npz"))
    other = _jax_trainer(jcfg, _Args(str(tmp_path), data_root),
                         _jax_state(params, 2), epoch=0, step=0)
    other.load_state_trees(trees, meta)
    for a, b in zip(jax.tree_util.tree_leaves(other.state),
                    jax.tree_util.tree_leaves(jt.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the preemption snapshot, resumed without a path
    assert not io.has_snapshot(str(tmp_path / "none"))
    pt.save_snapshot()
    fresh = _port_trainer(tmp_path, data_root)
    assert fresh.resume()
    _assert_trainer_holds(fresh, jt.state, 1, 3)
    assert set(os.listdir(pt.ckpt_dir)) == {"from_jax.npz", "from_port.npz",
                                            "snapshot"}


def test_checkpoint_trees_refuse_other_shapes(tmp_path, data_root):
    pt = _port_trainer(tmp_path, data_root)
    trees = pt.state_trees()
    del trees["model"]["decoder"]
    with pytest.raises(KeyError, match="decoder"):
        pt.load_state_trees(trees, {})
    trees = pt.state_trees()
    del trees["opt"]["leaf_1"]
    with pytest.raises(ValueError, match="leaves"):
        pt.load_state_trees(trees, {})


# --------------------------------------------------------------- writer
def test_writer_writes_what_lion_tpu_writes(tmp_path):
    lines = []
    for cls, d in ((Writer, tmp_path / "port"), (JaxWriter, tmp_path / "jax")):
        w = cls(log_dir=str(d))
        w.avg_meter("train/loss", 1.0)
        w.avg_meter("train/loss", 2.0, n=3)
        w.upload_meter(7)
        w.add_scalar("eval/x", 0.5, 8)
        w.close()
        with open(d / "metrics.jsonl") as f:
            lines.append([{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in f])
    assert lines[0] == lines[1] == [
        {"tag": "train/loss", "value": 1.75, "step": 7},
        {"tag": "eval/x", "value": 0.5, "step": 8}]


@pytest.mark.parametrize("var", ["USE_TFB", "USE_WB", "USE_COMET"])
def test_writer_refuses_the_optional_sinks(tmp_path, monkeypatch, capsys,
                                           var):
    """A sink asked for by its variable whose package cannot be imported
    is refused with one printed line (once refused outright); the JSONL
    sink goes on, and add_image (once refused) writes its PNG."""
    module = {"USE_TFB": "torch.utils.tensorboard", "USE_WB": "wandb",
              "USE_COMET": "comet_ml"}[var]
    monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.setenv(var, "1")
    w = Writer(log_dir=str(tmp_path), use_tensorboard=var == "USE_TFB")
    assert "cannot start" in capsys.readouterr().out
    w.add_scalar("eval/x", 0.5, 8)
    path = w.add_image("vis/sample", np.zeros((4, 6, 3), np.uint8), 9)
    w.close()
    assert path == str(tmp_path / "images" / "vis_sample_9.png")
    with open(path, "rb") as f:
        assert f.read(4) == b"\x89PNG"
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(line)["tag"] for line in f] == ["eval/x",
                                                           "vis/sample"]


# -------------------------------------------------------------- trainer
def test_trainer_trains_saves_resumes_and_scores_on_the_cpu(tmp_path,
                                                            data_root):
    pt = _port_trainer(tmp_path, data_root)
    params0 = [p.detach().clone() for p in pt.step_fn.params]
    pt.train_epochs()
    assert (pt.epoch, pt.step) == (1, 4)            # 2 epochs x 2 batches
    files = set(os.listdir(pt.ckpt_dir))
    assert {"final.npz", "best_eval.npz"} <= files
    assert pt.best_eval_score > 0
    moved = [not torch.equal(p, q) for p, q in zip(pt.step_fn.params,
                                                   params0)]
    assert all(torch.isfinite(p).all() for p in pt.step_fn.params)
    assert sum(moved) > 0.9 * len(moved)
    with open(os.path.join(str(tmp_path), "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"train/loss", "train/print/kl_weight", "train/epoch_time",
            "eval/nll_MMD-CD", "eval/nll_MMD-EMD",
            "eval/best_score"} <= tags

    again = _port_trainer(tmp_path, data_root)
    assert again.resume(os.path.join(pt.ckpt_dir, "final.npz"))
    assert (again.epoch, again.step) == (1, 4)
    for a, b in ((again.step_fn.params, pt.step_fn.params),
                 (again.step_fn.ema.shadow, pt.step_fn.ema.shadow),
                 *zip(again.step_fn.optimizer.moments(),
                      pt.step_fn.optimizer.moments())):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert again.step_fn.optimizer.count == 4
    # a step after the resume is the step the trained Trainer takes
    x = again.put_batch(next(iter(again.train_loader))["tr_points"])
    for t in (pt, again):
        t.step_fn(x, torch.Generator().manual_seed(6))
    assert all(torch.equal(a, b) for a, b in zip(again.step_fn.params,
                                                 pt.step_fn.params))

    results = again.eval_nll()
    assert set(results) == {"score_detail", "MMD-CD", "MMD-EMD"}
    assert results["score_detail"].shape == (4,)
    assert np.isfinite([results["MMD-CD"], results["MMD-EMD"]]).all()
    # sampling decodes from the EMA copy and leaves the parameters as
    # they were
    trained = [p.detach().clone() for p in again.step_fn.params]
    gen = lambda: torch.Generator().manual_seed(3)
    out = again.sample(2, generator=gen())
    assert out.shape == (2, 32, 3) and torch.isfinite(out).all()
    assert all(torch.equal(p, q) for p, q in zip(again.step_fn.params,
                                                 trained))
    with torch.no_grad():
        for p, e in zip(again.step_fn.params, again.step_fn.ema.shadow):
            p.copy_(e)
    assert torch.equal(again.sample(2, generator=gen()), out)


@pytest.mark.parametrize("key,value,match", [
    ("data__cond_on_cat", True, "item J2")])
def test_trainer_refuses_what_is_not_ported(tmp_path, data_root, key, value,
                                            match):
    """Class conditioning (once refused as item J2): the stage-1 trainer
    builds with the class embedding and trains on the batches' cate_idx,
    and refuses a data.nclass below the categories of data.cates (the
    labels past it would have no one-hot row)."""
    pt = _port_trainer(tmp_path, data_root, **{key: value})
    assert tuple(pt.vae.class_embedding.kernel.shape)[0] == \
        pt.cfg.data.nclass
    metrics = pt.train_iter(next(iter(pt.train_loader)), 0)
    assert np.isfinite(metrics["loss"])
    pt.writer.close()
    with pytest.raises(ValueError, match="data.nclass"):
        _port_trainer(tmp_path, data_root, data__nclass=0, **{key: value})


@pytest.mark.parametrize("viz_freq", [400, -2])
def test_trainer_draws_the_visualizations(tmp_path, data_root, viz_freq):
    """viz.viz_freq != 0 (once refused): the Trainer builds, and its
    reconstruction and sample grids go to images/ and metrics.jsonl; the
    reconstruction leaves the parameters as they were."""
    pt = _port_trainer(tmp_path, data_root, viz__viz_freq=viz_freq)
    params = [p.detach().clone() for p in pt.step_fn.params]
    batch = next(iter(pt.train_loader))
    pt.vis_recont(batch, 3)
    pt.vis_sample(3)
    pt.writer.close()
    assert sorted(os.listdir(tmp_path / "images")) == ["vis_recont_3.png",
                                                       "vis_sample_3.png"]
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(line)["tag"] for line in f] == ["vis/recont",
                                                           "vis/sample"]
    assert all(torch.equal(p, q) for p, q in zip(pt.step_fn.params, params))


@pytest.mark.parametrize("key", ["tpu__bf16"])
def test_trainer_trains_bf16_and_its_checkpoint_resumes_in_fp32(
        tmp_path, data_root, key):
    """bf16 training (once refused): the stage-1 Trainer under tpu.bf16
    trains its epoch with the VAE's U-Nets in bf16 and float32 parameters;
    its final checkpoint resumes equal into an fp32 Trainer and back."""
    bf = _port_trainer(tmp_path, data_root, **{key: True})
    assert bf.cfg.tpu.bf16
    run_in_bf16([bf.vae.encoder, bf.vae.decoder], bf.train_epochs)
    step = bf.step_fn
    assert step.optimizer.count == bf.step > 0
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in step.params + step.ema.shadow)
    fp = _port_trainer(tmp_path, data_root)
    fp.resume(os.path.join(bf.ckpt_dir, "final.npz"))
    assert not fp.cfg.tpu.bf16
    for a, b in zip(fp.step_fn.params + fp.step_fn.ema.shadow,
                    step.params + step.ema.shadow):
        assert torch.equal(a, b)


def test_trainer_defaults_to_the_card(tmp_path, data_root):
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without CUDA")
    cfg = trainer_cfg(get_default_cfg(), str(tmp_path), data_root)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, _Args(str(tmp_path), data_root))


def test_stage1_modules_import_leaves_jax_out():
    code = ("import sys, lion_tpu_torch.trainers.hvae_trainer, "
            "lion_tpu_torch.ckpt, lion_tpu_torch.data, lion_tpu_torch.utils;"
            "bad = [m for m in ('jax', 'flax', 'optax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
