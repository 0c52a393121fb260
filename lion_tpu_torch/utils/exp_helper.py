"""Experiment naming and timing helpers (port of lion_tpu/utils/
exp_helper.py).

An experiment is named by the md5-6 of its config dump; eval tags include
the git hash.
"""
from __future__ import annotations

import hashlib
import subprocess
import time


def hash_config(cfg_str: str, length: int = 6) -> str:
    return hashlib.md5(cfg_str.encode()).hexdigest()[:length]


def get_git_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "nogit"


def get_expname(cfg) -> str:
    return f"{cfg.data.cates}_{hash_config(cfg.dump())}"


def get_evalname(cfg) -> str:
    tag = get_git_hash()
    ddim = f"_ddim{cfg.eval_ddim_step}" if cfg.eval_ddim_step else ""
    return f"eval_{tag}{ddim}"


class ExpTimer:
    """ETA meter over a known number of iterations (exp_helper.py:45-66)."""

    def __init__(self, total_iter: int):
        self.total_iter = total_iter
        self.times = []
        self._tic = None

    def tic(self):
        self._tic = time.time()

    def toc(self):
        if self._tic is not None:
            self.times.append(time.time() - self._tic)
            self._tic = None

    def hours_left(self) -> float:
        if not self.times:
            return 0.0
        avg = sum(self.times) / len(self.times)
        remaining = self.total_iter - len(self.times)
        return avg * remaining / 3600.0
