"""The port's training CLI and lion_tpu's, run on the same argv on the CPU:
stage 1 with `scripts/train_vae.sh`'s overrides, the tiny settings after
them and the visualizations every step, through the root `train_dist.main`
and `lion_tpu_torch.train_dist.main`. Both write the same experiment
directory (its name, `cfg.yml`, the checkpoint files, the image files) and
the same `metrics.jsonl` records in the same order: the tags, the steps and
the kinds (scalar or image). This file holds lion_tpu's run apart from
test_torch_port_cli.py for the suite's time (lion_tpu's step, recont and
sample compile in ~80 s here).
"""
import json
import os

import pytest

from test_torch_port_cli import stage1_argv
from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_trainer import data_root  # noqa: F401


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], "image" if "image" in r else "value")
                for r in map(json.loads, f)]


def _tree(save_dir):
    return {d: sorted(os.listdir(os.path.join(save_dir, d)))
            for d in ("", "checkpoints", "images")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_root):
    import train_dist as jax_train_dist
    from lion_tpu_torch import train_dist
    out = {}
    for pkg, main in (("jax", jax_train_dist.main),
                      ("port", train_dist.main)):
        exp = tmp_path_factory.mktemp(pkg) / "exp"
        argv = stage1_argv(exp, data_root)
        if pkg == "jax":      # the root CLI has no --device
            i = argv.index("--device")
            argv = argv[:i] + argv[i + 2:]
        main(argv)
        (save_dir,) = [os.path.join(exp, d) for d in os.listdir(exp)]
        out[pkg] = save_dir
    return out


def test_stage1_cli_writes_lion_tpus_experiment(runs):
    assert os.path.basename(runs["port"]) == os.path.basename(runs["jax"])
    assert _tree(runs["port"]) == _tree(runs["jax"])
    assert _tree(runs["port"])["images"] == [
        "vis_recont_1.png", "vis_recont_2.png", "vis_sample_1.png",
        "vis_sample_2.png"]
    with open(os.path.join(runs["port"], "cfg.yml")) as f:
        port = f.read()
    with open(os.path.join(runs["jax"], "cfg.yml")) as f:
        want = f.read()
    assert port == want.replace(os.path.dirname(runs["jax"]),
                                os.path.dirname(runs["port"]))


def test_stage1_cli_logs_lion_tpus_tags(runs):
    port, want = _records(runs["port"]), _records(runs["jax"])
    assert port == want
    assert ("vis/recont", 2, "image") in port
    assert ("train/epoch_time", 0, "value") in port
