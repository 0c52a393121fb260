"""Named spans at the port's layer boundaries.

`span(name)` is a context manager that keeps its host seconds (`seconds`,
two `time.perf_counter` reads) always. While a profiler records
(`torch.autograd._profiler_enabled()`), it also opens a
`torch.profiler.record_function(name)` range, which lands in the
profiler's trace as a user annotation on the clock of the device's kernels
and the CUDA runtime calls. Without a profiler it does nothing more: no
device work, no sync, no tensor.

The port's spans, each opened a few times a step at most:

    sample                      LION._sample, one a request
      sample.global, sample.local, sample.decode
                                its three stages, each closed after the
                                device sync that `stage_seconds` reads
        chain.prior             a chain step's prior call
        chain.update            the rest of the step: the update and its
                                noise draw (in the ancestral sampler the
                                whole step, around its chain.prior)
    train.step                  TrainStep.__call__
      train.forward             the objective (the loss)
        prior.encode            the two-prior loss's frozen VAE encode
      train.backward            loss.backward()
      train.update              gradient fill and average, Adam, EMA,
                                after_update
"""
from __future__ import annotations

import time

import torch


class span:
    """`with span(name) as s: ...`; `s.seconds` after the block."""

    __slots__ = ("name", "seconds", "_start", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._start
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
