"""The port's CLIs against the JAX package's on the CPU at tiny widths:
`python -m lion_tpu_torch.train_dist` with the overrides of
`scripts/train_vae.sh` and `scripts/train_prior.sh` read from the files
(the tiny settings of test_torch_port_trainer.py's `trainer_cfg` and
test_torch_port_stage2.py's `stage2_cfg` appended after them, as
tests/test_cli.py appends its own), and `python -m lion_tpu_torch.demo`.

- `build_cfg`: the same `cfg.yml` bytes, hash and experiment directory as
  the root `train_dist.build_cfg` on the same argv.
- Stage 1 with the visualizations every step: the experiment directory,
  `metrics.jsonl`, the grids under `images/`; a rerun resumes from the
  snapshot and its step goes on; `--pretrained` loads.
- Stage 2 on that checkpoint; `--eval_generation` (with and without
  `--skip_sample`) writes the results line of `lion_tpu.eval.
  compute_score` on the same files, byte for byte.
- The demo samples from a trainer's `.npz` (its EMA priors) and from its
  `.pt` export exactly what `LION.sample` gives with the EMA weights and
  the same generator.

The CLIs run in this process (`main(argv)`), not as subprocesses.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lion_tpu.eval import compute_score as jax_compute_score

from lion_tpu_torch import demo, train_dist
from lion_tpu_torch.ckpt import load_checkpoint
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models import LION

from test_torch_port_sample import one_torch_thread, ROOT  # noqa: F401
from test_torch_port_trainer import data_root  # noqa: F401

# test_torch_port_trainer.trainer_cfg as overrides: tests/test_trainers.py's
# tiny stage-1 shapes, the style encoder shrunk by the size multipliers and
# the U-Net specs scaled back up; one epoch of 2 steps, the visualizations
# every step, a snapshot after every epoch
TINY_STAGE1 = [
    "data.tr_max_sample_points", "32", "data.te_max_sample_points", "32",
    "shapelatent.decoder_num_points", "32",
    "data.batch_size", "4", "data.batch_size_test", "4",
    "ddpm.dropout", "0.0", "trainer.epochs", "1", "trainer.opt.ema_decay",
    "0.9", "viz.log_freq", "1", "viz.viz_freq", "1", "viz.save_freq", "-1",
    "viz.val_freq", "-1", "snapshot_min", "0", "num_val_samples", "4",
    "tpu.sa_blocks",
    "[[[8,1,16],[256,0.2,4,[8,16]]],[null,[128,0.4,4,[16,16]]]]",
    "tpu.fp_blocks", "[[[16,16],[16,1,16]],[[16,8],[8,1,16]]]",
    "tpu.ncenter_mult", "0.03125", "tpu.vres_mult", "0.25"]
# test_torch_port_stage2.stage2_cfg's priors and chain on top; the sample
# grids at 2 DDIM steps, the evaluation at 2
TINY_STAGE2 = TINY_STAGE1 + [
    "ddpm.num_steps", "5", "sde.num_channels_dae", "16",
    "sde.num_cell_per_scale_dae", "1", "sde.embedding_dim", "8",
    "sde.warmup_epochs", "0", "sde.dropout", "0.0", "sde.ema_decay", "0.9",
    "viz.vis_sample_ddim_step", "2", "eval_ddim_step", "2"]
CATE = "airplane"


def script(name: str, **values) -> list:
    return train_dist.script_overrides(
        os.path.join(ROOT, "scripts", f"{name}.sh"), CATE=CATE, **values)


def stage1_argv(exp_root, data_root, *flags):
    return ["--exp_root", str(exp_root), "--data_root", data_root,
            "--device", "cpu", *flags] + script("train_vae") + TINY_STAGE1


def stage2_argv(exp_root, data_root, vae_ckpt, *flags):
    return ["--exp_root", str(exp_root), "--data_root", data_root,
            "--device", "cpu", *flags] + \
        script("train_prior", VAE_CKPT=vae_ckpt) + TINY_STAGE2


def tags(save_dir):
    import json
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def stage1(tmp_path_factory, data_root):
    exp = tmp_path_factory.mktemp("cli1") / "exp"
    trainer = train_dist.main(stage1_argv(exp, data_root))
    return {"exp": exp, "save_dir": trainer.save_dir, "step": trainer.step,
            "params": [p.detach().clone() for p in trainer.step_fn.params]}


@pytest.fixture(scope="module")
def stage2(tmp_path_factory, data_root, stage1):
    exp = tmp_path_factory.mktemp("cli2") / "exp"
    vae = os.path.join(stage1["save_dir"], "checkpoints", "final.npz")
    trainer = train_dist.main(stage2_argv(exp, data_root, vae))
    return {"trainer": trainer, "save_dir": trainer.save_dir}


# ------------------------------------------------------------- build_cfg
@pytest.mark.parametrize("name", ["train_vae", "train_prior"])
def test_build_cfg_matches_train_dist(tmp_path, monkeypatch, data_root,
                                      name):
    """The same cfg.yml bytes, hash and save_dir as the root
    train_dist.build_cfg on the same argv (a relative --exp_root, each
    package in its own working directory)."""
    import train_dist as jax_train_dist
    opts = script(name, VAE_CKPT="/ckpt/stage1.npz") + (
        TINY_STAGE1 if name == "train_vae" else TINY_STAGE2)
    argv = ["--exp_root", "./exp", "--data_root", data_root] + opts
    out = {}
    for pkg, mod in (("jax", jax_train_dist), ("port", train_dist)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        cfg = mod.build_cfg(mod.get_args(argv))
        with open(os.path.join(cfg.save_dir, "cfg.yml"), "rb") as f:
            out[pkg] = (f.read(), cfg.hash, cfg.save_dir)
    assert out["port"] == out["jax"]
    assert out["port"][2] == f"./exp/{CATE}_{out['port'][1]}"
    assert b"tpu:" in out["port"][0] and b"bf16: true" in out["port"][0]


def test_script_overrides_are_the_jax_scripts_word_for_word():
    for name, values in (("train_vae", {}),
                         ("train_prior", {"VAE_CKPT": "/v.npz"})):
        port = train_dist.script_overrides(
            os.path.join(ROOT, "lion_tpu_torch", "scripts", f"{name}.sh"),
            CATE=CATE, **values)
        assert port == script(name, **values)
        assert "--data_root" not in port and CATE in port
    assert script("train_vae")[:4] == ["trainer.type",
                                       "trainers.hvae_trainer", "data.cates",
                                       CATE]


# --------------------------------------------------------------- stage 1
def test_stage1_writes_the_experiment(stage1):
    d = stage1["save_dir"]
    assert os.path.basename(d).startswith(f"{CATE}_")
    assert sorted(os.listdir(d)) == ["cfg.yml", "checkpoints", "images",
                                     "metrics.jsonl"]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "final.npz", "snapshot"]
    assert sorted(os.listdir(os.path.join(d, "images"))) == [
        "vis_recont_1.png", "vis_recont_2.png", "vis_sample_1.png",
        "vis_sample_2.png"]
    lines = tags(d)
    images = [(r["tag"], r["step"]) for r in lines if "image" in r]
    assert images == [("vis/recont", 1), ("vis/sample", 1),
                      ("vis/recont", 2), ("vis/sample", 2)]
    scalars = {r["tag"]: r["step"] for r in lines if "value" in r}
    assert scalars["train/epoch_time"] == 0 and scalars["train/loss"] == 2
    assert np.isfinite([r["value"] for r in lines if "value" in r]).all()
    _, meta = load_checkpoint(os.path.join(d, "checkpoints", "final.npz"))
    assert (meta["epoch"], meta["step"]) == (0, 2) == (0, stage1["step"])


def test_stage1_rerun_resumes_from_the_snapshot(tmp_path, data_root, stage1,
                                                capsys):
    """The same command again resumes from the experiment's snapshot: its
    parameters load and the step goes on."""
    exp = tmp_path / "exp"
    shutil.copytree(stage1["exp"], exp)
    again = train_dist.main(stage1_argv(exp, data_root))
    assert f"resumed at epoch 0 step {stage1['step']}" in \
        capsys.readouterr().out
    assert again.step == 2 * stage1["step"]
    assert again.save_dir.endswith(os.path.basename(stage1["save_dir"]))
    _, meta = load_checkpoint(os.path.join(again.ckpt_dir, "snapshot"))
    assert meta["step"] == 4
    assert [r["step"] for r in tags(again.save_dir)
            if r["tag"] == "vis/sample"] == [1, 2, 3, 4]


def test_stage1_pretrained_loads(tmp_path, data_root, stage1, capsys):
    """--pretrained in a fresh experiment directory: the checkpoint's
    parameters load and the step goes on from its step."""
    final = os.path.join(stage1["save_dir"], "checkpoints", "final.npz")
    loaded = {}
    from lion_tpu_torch.trainers.hvae_trainer import Trainer
    resume = Trainer.resume

    def spy(self, path=None):
        out = resume(self, path)
        loaded["params"] = [p.detach().clone() for p in self.step_fn.params]
        return out
    Trainer.resume = spy
    try:
        tr = train_dist.main(stage1_argv(tmp_path / "exp", data_root,
                                         "--pretrained", final))
    finally:
        Trainer.resume = resume
    assert "resumed at epoch 0 step 2" in capsys.readouterr().out
    assert all(torch.equal(a, b)
               for a, b in zip(loaded["params"], stage1["params"]))
    assert tr.step == 4


def test_resume_without_a_snapshot_warns(tmp_path, data_root, capsys):
    tr = train_dist.main(stage1_argv(tmp_path / "exp", data_root,
                                     "--resume"))
    assert "--resume given but no snapshot found" in capsys.readouterr().out
    assert tr.step == 2


def test_distributed_init_names_item_i(tmp_path, data_root, monkeypatch):
    """--distributed_init (once refused as item I) joins the group that
    torchrun's environment describes: without it, it stops before the
    experiment exists, naming the variables (tests/test_torch_port_dist.py
    runs it on two ranks)."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_dist.main(stage1_argv(tmp_path / "exp", data_root,
                                    "--distributed_init"))
    assert not (tmp_path / "exp").exists()


def test_set_detect_anomaly_turns_on_autograd_anomaly_mode(capsys):
    cfg = get_default_cfg()
    cfg.set_detect_anomaly = 1
    try:
        train_dist.apply_debug_flags(cfg)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert "set_detect_anomaly is on" in capsys.readouterr().out


# --------------------------------------------------------------- stage 2
def test_stage2_trains_on_the_stage1_checkpoint(stage1, stage2):
    tr = stage2["trainer"]
    assert tr.step == 2 and tr.cfg.tpu.bf16
    stage1_vae = load_checkpoint(os.path.join(
        stage1["save_dir"], "checkpoints", "final.npz"))[0]["model"]
    trees, meta = load_checkpoint(os.path.join(tr.ckpt_dir, "final.npz"))
    from lion_tpu_torch.ckpt.io import flatten_tree
    a, b = flatten_tree(trees["vae"]), flatten_tree(stage1_vae)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert sorted(os.listdir(os.path.join(tr.save_dir, "images"))) == [
        "vis_sample_1.png", "vis_sample_2.png"]
    assert meta["step"] == 2


def _ref_set(path, n, points, seed):
    rs = np.random.RandomState(seed)
    torch.save({
        "ref": torch.from_numpy(
            rs.randn(n, points, 3).astype(np.float32) * 0.2),
        "mean": torch.from_numpy(rs.randn(n, 1, 3).astype(np.float32) * 0.1),
        "std": torch.from_numpy(
            np.abs(rs.randn(n, 1, 1)).astype(np.float32) + 0.5)}, path)


def test_eval_generation_scores_as_lion_tpu(tmp_path, monkeypatch, stage2):
    """--eval_generation samples 4 shapes (2 DDIM steps) into
    eval/samples.pt and scores them against ./datasets/test_data/
    ref_val_airplane.pt; a second run with --skip_sample scores the same
    file again. Both lines equal lion_tpu.eval.compute_score's on the same
    files, byte for byte."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("datasets/test_data")
    ref = os.path.abspath(f"datasets/test_data/ref_val_{CATE}.pt")
    _ref_set(ref, 4, 32, seed=7)
    d = stage2["save_dir"]
    argv = ["--config", os.path.join(d, "cfg.yml"), "--pretrained",
            os.path.join(d, "checkpoints", "final.npz"), "--device", "cpu",
            "--eval_generation", "--num_samples", "4"]
    first = train_dist.main(argv)
    samples = os.path.join(d, "eval", "samples.pt")
    pts = torch.load(samples)
    assert pts.shape == (4, 32, 3) and torch.isfinite(pts).all()
    train_dist.main(argv + ["--skip_sample"])
    assert torch.equal(torch.load(samples), pts)
    jax_compute_score(samples, ref, batch_size_test=4, dataset=CATE,
                      hash=first.cfg.hash, step=first.step,
                      results_dir=str(tmp_path / "jax"))
    with open(os.path.join(d, "results", "eval_out.csv"), "rb") as f:
        port = f.read().splitlines()
    with open(tmp_path / "jax" / "eval_out.csv", "rb") as f:
        want = f.read().splitlines()
    assert port == want * 2 and len(want) == 2 and b"airplane" in want[1]


# ------------------------------------------------------------------- demo
def _ema_sample(cfg, trees, n, seed, ddim_step=0):
    lion = LION(cfg, device="cpu").load_jax_params({
        "vae": trees["vae"], "global_prior": trees["ema_global"],
        "local_prior": trees["ema_local"]})
    return lion.sample(n, torch.Generator().manual_seed(seed),
                       ddim_step=ddim_step)


def test_demo_samples_the_ema_from_npz_and_pt(tmp_path, stage2):
    d = stage2["save_dir"]
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(d, "cfg.yml"))
    final = os.path.join(d, "checkpoints", "final.npz")
    trees, _ = load_checkpoint(final)
    want = _ema_sample(cfg, trees, 3, seed=5)
    dae = LION(cfg, device="cpu").load_jax_params({
        "vae": trees["vae"], "global_prior": trees["dae_global"],
        "local_prior": trees["dae_local"]}).sample(
            3, torch.Generator().manual_seed(5))
    assert not torch.equal(dae["points"], want["points"])
    pt = str(tmp_path / "lion.pt")
    stage2["trainer"].export_torch(pt)
    for ckpt in (final, pt):
        out = str(tmp_path / f"{os.path.basename(ckpt)}.npz")
        demo.main(["--config", os.path.join(d, "cfg.yml"), "--ckpt", ckpt,
                   "--num_samples", "3", "--seed", "5", "--out", out,
                   "--device", "cpu"])
        with np.load(out) as got:
            assert sorted(got.files) == ["points", "z_global", "z_local"]
            for k in got.files:
                np.testing.assert_array_equal(got[k], want[k].numpy(),
                                              err_msg=f"{ckpt} {k}")


def test_demo_ddim_random_init_and_plot(tmp_path, stage2, capsys):
    d = stage2["save_dir"]
    out, png = str(tmp_path / "s.npz"), str(tmp_path / "s.png")
    demo.main(["--config", os.path.join(d, "cfg.yml"), "--num_samples", "2",
               "--ddim_step", "2", "--seed", "1", "--out", out, "--plot",
               png, "--device", "cpu"])
    assert "no checkpoint given" in capsys.readouterr().out
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(d, "cfg.yml"))
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    want = lion.sample(2, torch.Generator().manual_seed(1), ddim_step=2)
    with np.load(out) as got:
        np.testing.assert_array_equal(got["points"], want["points"].numpy())
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flag", ["--text", "--clip_feat"])
def test_demo_refuses_clip_conditioning(tmp_path, stage2, flag):
    """--text / --clip_feat (once refused as item J2) condition a CLIP
    prior: a config without clipforge.enable, whose priors would ignore
    the features, refuses them (tests/test_torch_port_clip.py runs them)."""
    with pytest.raises(ValueError, match="clipforge.enable"):
        demo.main(["--config", os.path.join(stage2["save_dir"], "cfg.yml"),
                   flag, "a chair", "--device", "cpu"])


def test_cli_modules_import_no_jax():
    code = ("import sys, lion_tpu_torch.train_dist, lion_tpu_torch.demo, "
            "lion_tpu_torch.utils.vis, lion_tpu_torch.utils.exp_helper, "
            "lion_tpu_torch.data.native;"
            "bad = [m for m in ('jax', 'flax', 'lion_tpu', 'matplotlib') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
