"""Experiment tracking (port of lion_tpu/utils/writer.py): console lines,
the always-on `metrics.jsonl` sink with the avg_meter / upload_meter
buffering (scalars logged through `avg_meter` accumulate and are written
once an epoch), images as PNGs under `<log_dir>/images/`, and the optional
sinks behind the JAX package's switches: TensorBoard (`use_tensorboard`,
which the trainers set from USE_TFB=1), wandb (USE_WB=1) and comet
(USE_COMET=1). A sink that was asked for and cannot be started prints one
line that says so; the JSONL sink goes on.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict


class AvgMeter:
    def __init__(self):
        self.sum = 0.0
        self.cnt = 0

    def update(self, val, n: int = 1):
        self.sum += float(val) * n
        self.cnt += n

    @property
    def avg(self):
        return self.sum / max(self.cnt, 1)


def _unavailable(sink: str, err: Exception) -> None:
    print(f"WARNING: the {sink} sink was asked for but cannot start "
          f"({type(err).__name__}: {err}); metrics.jsonl is written "
          "without it", flush=True)


def _tensorboard(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir)
    except Exception as err:
        _unavailable("TensorBoard (USE_TFB)", err)


def _wandb(log_dir: str):
    try:
        import wandb
        return wandb.init(project=os.environ.get("WB_PROJECT", "lion_tpu"),
                          dir=log_dir, resume="allow")
    except Exception as err:
        _unavailable("wandb (USE_WB)", err)


def _comet():
    try:
        from comet_ml import Experiment
        return Experiment(project_name=os.environ.get("COMET_PROJECT",
                                                      "lion_tpu"))
    except Exception as err:
        _unavailable("comet (USE_COMET)", err)


def _save_png(path: str, img) -> None:
    """An HWC uint8 image as a PNG, through PIL, else matplotlib."""
    try:
        from PIL import Image
    except ImportError:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, img)
        return
    Image.fromarray(img).save(path)


class Writer:
    """Rank 0 writes; other ranks only keep meters."""

    def __init__(self, log_dir: str = "", rank: int = 0,
                 use_tensorboard: bool = False):
        self.rank = rank
        self.log_dir = log_dir
        self.meters: Dict[str, AvgMeter] = defaultdict(AvgMeter)
        self._jsonl = self._tb = self._wandb = self._comet = None
        if rank != 0 or not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            self._tb = _tensorboard(log_dir)
        if os.environ.get("USE_WB", "0") == "1":
            self._wandb = _wandb(log_dir)
        if os.environ.get("USE_COMET", "0") == "1":
            self._comet = _comet()

    def _line(self, record: dict) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({**record, "time": time.time()})
                              + "\n")
            self._jsonl.flush()

    def add_scalar(self, tag: str, value, step: int):
        if self.rank != 0:
            return
        self._line({"tag": tag, "value": float(value), "step": int(step)})
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wandb is not None:
            self._wandb.log({tag: float(value)}, step=int(step))
        if self._comet is not None:
            self._comet.log_metric(tag, float(value), step=int(step))

    def add_image(self, tag: str, img, step: int):
        """Save an HWC uint8 image as `<log_dir>/images/<tag>_<step>.png`
        ('/' in the tag becomes '_'), note it in the JSONL stream and pass
        it to the optional sinks; returns the path."""
        if self.rank != 0 or not self.log_dir:
            return None
        import numpy as np
        img = np.asarray(img)
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir,
                            f"{tag.replace('/', '_')}_{int(step)}.png")
        _save_png(path, img)
        self._line({"tag": tag, "image": path, "step": int(step)})
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
        if self._comet is not None:
            self._comet.log_image(path, name=tag, step=int(step))
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(path)}, step=int(step))
        return path

    def avg_meter(self, tag: str, value, n: int = 1):
        self.meters[tag].update(value, n)

    def upload_meter(self, step: int):
        for tag, meter in self.meters.items():
            self.add_scalar(tag, meter.avg, step)
        self.meters.clear()

    def log(self, msg: str):
        if self.rank == 0:
            print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        if self._comet is not None:
            self._comet.end()
            self._comet = None
