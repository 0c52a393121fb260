"""The port's visualization, writer and experiment helpers against
lion_tpu's on the CPU: `utils/vis` renders the same pixels, the writer
writes the same JSONL records (apart from `time`) and the same PNGs, its
TensorBoard sink writes an event file, a sink that cannot start says so,
and `utils/exp_helper` gives the same names, hashes and timings. The
trainers check for matplotlib when they are built with the visualizations
on.
"""
import json
import os
import sys

import numpy as np
import pytest

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.utils import exp_helper as jexp
from lion_tpu.utils import vis as jvis
from lion_tpu.utils.writer import Writer as JaxWriter

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.utils import exp_helper, vis
from lion_tpu_torch.utils.writer import Writer

from test_torch_port_sample import one_torch_thread  # noqa: F401


def clouds(seed, b, n=64):
    return (np.random.RandomState(seed).randn(b, n, 3) * 0.4).astype(
        np.float32)


def _png(path):
    import matplotlib.image as mpimg
    return mpimg.imread(path)


# ------------------------------------------------------------------ vis
@pytest.mark.parametrize("b", [1, 3, 6])
def test_visualize_point_clouds_3d_equals_lion_tpu(b):
    pcs = list(clouds(b, b))
    titles = [f"gen-{i}" for i in range(b)]
    got = vis.visualize_point_clouds_3d(pcs, titles)
    want = jvis.visualize_point_clouds_3d(pcs, titles)
    assert got.dtype == np.uint8 and got.shape == (300, 300 * b, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(vis.visualize_point_clouds_3d(pcs, bound=0.5),
                          jvis.visualize_point_clouds_3d(pcs, bound=0.5))


@pytest.mark.parametrize("shape", [(5, 64, 3), (64, 3)])
def test_plot_points_equals_lion_tpu(tmp_path, shape):
    pts = clouds(7, 5).reshape(shape) if len(shape) == 3 else clouds(7, 1)[0]
    titles = ["a", "b"]
    got = vis.plot_points(pts, str(tmp_path / "port.png"), titles=titles)
    jvis.plot_points(pts, str(tmp_path / "jax.png"), titles=titles)
    assert got == str(tmp_path / "port.png")
    assert np.array_equal(_png(tmp_path / "port.png"),
                          _png(tmp_path / "jax.png"))


# --------------------------------------------------------------- writer
def _write(cls, log_dir, **kwargs):
    w = cls(log_dir=str(log_dir), **kwargs)
    w.avg_meter("train/loss", 1.0)
    w.avg_meter("train/loss", 2.0, n=3)
    w.upload_meter(7)
    w.add_scalar("eval/x", 0.5, 8)
    img = vis.visualize_point_clouds_3d(list(clouds(3, 2)), ["p", "q"])
    path = w.add_image("vis/recont", img, 9)
    w.log("done")
    w.close()
    return path


def _records(log_dir):
    path = os.path.join(str(log_dir), "metrics.jsonl")
    if not os.path.exists(path):
        return None
    out = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            assert set(r) >= {"tag", "step", "time"}
            r.pop("time")
            if "image" in r:
                r["image"] = os.path.relpath(r["image"], str(log_dir))
            out.append(r)
    return out


def test_writer_writes_lion_tpus_lines_and_images(tmp_path):
    paths = [_write(cls, tmp_path / d)
             for cls, d in ((Writer, "port"), (JaxWriter, "jax"))]
    assert _records(tmp_path / "port") == _records(tmp_path / "jax") == [
        {"tag": "train/loss", "value": 1.75, "step": 7},
        {"tag": "eval/x", "value": 0.5, "step": 8},
        {"tag": "vis/recont", "image": "images/vis_recont_9.png",
         "step": 9}]
    assert paths[0] == str(tmp_path / "port" / "images" / "vis_recont_9.png")
    assert np.array_equal(_png(paths[0]), _png(paths[1]))


def test_writer_of_another_rank_writes_nothing(tmp_path):
    for cls, d in ((Writer, "port"), (JaxWriter, "jax")):
        assert _write(cls, tmp_path / d, rank=1) is None
        assert not (tmp_path / d).exists()


def test_tensorboard_sink_writes_an_event_file(tmp_path):
    _write(Writer, tmp_path, use_tensorboard=True)
    events = [f for f in os.listdir(tmp_path)
              if f.startswith("events.out.tfevents")]
    assert len(events) == 1 and os.path.getsize(tmp_path / events[0]) > 0
    assert len(_records(tmp_path)) == 3


@pytest.mark.parametrize("var,module,sink", [
    ("USE_TFB", "torch.utils.tensorboard", "TensorBoard"),
    ("USE_WB", "wandb", "wandb"), ("USE_COMET", "comet_ml", "comet")])
def test_a_sink_that_cannot_start_says_so(tmp_path, monkeypatch, capsys, var,
                                          module, sink):
    monkeypatch.setitem(sys.modules, module, None)
    monkeypatch.setenv(var, "1")
    _write(Writer, tmp_path, use_tensorboard=var == "USE_TFB")
    out = capsys.readouterr().out
    assert out.count(f"the {sink} ") == 1 and "cannot start" in out
    assert len(_records(tmp_path)) == 3


# ----------------------------------------------------------- exp_helper
def test_exp_helper_equals_lion_tpu(monkeypatch):
    cfgs = [get_default_cfg(), jax_default_cfg()]
    for cfg in cfgs:
        cfg.data.cates = "chair"
        cfg.eval_ddim_step = 50
    assert exp_helper.hash_config("abc") == jexp.hash_config("abc")
    assert exp_helper.hash_config("abc", 10) == jexp.hash_config("abc", 10)
    assert exp_helper.get_expname(cfgs[0]) == jexp.get_expname(cfgs[1])
    assert exp_helper.get_evalname(cfgs[0]) == jexp.get_evalname(cfgs[1])
    assert exp_helper.get_evalname(cfgs[0]).endswith("_ddim50")
    assert exp_helper.get_git_hash() == jexp.get_git_hash()
    monkeypatch.setenv("PATH", "")
    assert exp_helper.get_git_hash() == "nogit"
    clock = iter([0.0, 2.0, 10.0, 14.0])
    monkeypatch.setattr(exp_helper.time, "time", lambda: next(clock))
    timer = exp_helper.ExpTimer(5)
    assert timer.hours_left() == 0.0
    for _ in range(2):
        timer.tic()
        timer.toc()
    assert timer.times == [2.0, 4.0]
    assert timer.hours_left() == pytest.approx(3.0 * 3 / 3600.0)


# ------------------------------------------------------------- trainers
@pytest.mark.parametrize("name", ["trainers.hvae_trainer",
                                  "trainers.train_2prior"])
def test_trainers_without_matplotlib_refuse_the_visualizations(
        tmp_path, monkeypatch, name):
    """With viz.viz_freq != 0 and no matplotlib, a trainer raises when it
    is built (lion_tpu would fail at the first grid); with viz.viz_freq 0
    the check passes."""
    from lion_tpu_torch.trainers import get_trainer
    from lion_tpu_torch.trainers.base import check_vis_supported
    cfg = get_default_cfg()
    cfg.trainer.type = name
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        get_trainer(name)(cfg, None, device="cpu")
    cfg.viz.viz_freq = 0
    check_vis_supported(cfg)
