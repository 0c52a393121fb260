"""Experiment tracking (port of lion_tpu/utils/writer.py): console lines
and the always-on `metrics.jsonl` sink, with the avg_meter / upload_meter
buffering (scalars logged through `avg_meter` accumulate and are written
once an epoch).

The optional sinks of the JAX package (TensorBoard under USE_TFB=1, wandb
under USE_WB=1, comet under USE_COMET=1) and `add_image` need packages the
port does not assume; asking for one raises NotImplementedError (ROADMAP
Queue 1 item J).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict

_OPTIONAL_SINKS = ("USE_TFB", "USE_WB", "USE_COMET")


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


class Writer:
    def __init__(self, log_dir: str = ""):
        asked = [k for k in _OPTIONAL_SINKS if os.environ.get(k, "0") == "1"]
        if asked:
            raise NotImplementedError(
                f"the writer's optional sinks ({', '.join(asked)}) are not "
                "ported (ROADMAP Queue 1 item J); metrics.jsonl is written "
                "always")
        self.log_dir = log_dir
        self.meters: Dict[str, AvgMeter] = defaultdict(AvgMeter)
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}) + "\n")
            self._jsonl.flush()

    def add_image(self, tag: str, img, step: int):
        raise NotImplementedError("image logging is not ported (ROADMAP "
                                  "Queue 1 item J)")

    def avg_meter(self, tag: str, value, n: int = 1):
        self.meters[tag].update(value, n)

    def upload_meter(self, step: int):
        for tag, meter in self.meters.items():
            self.add_scalar(tag, meter.avg, step)
        self.meters.clear()

    def log(self, msg: str):
        print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
