"""The yardstick's arithmetic: the H100's published peaks and the work of
one request or step, counted from the reference at the cell's shapes.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3. The model's FLOPs are what
torch.utils.flop_counter counts of the reference (matrix products and
convolutions; forward for sampling, forward and backward for training),
so the count does not move with the program. The 3x3x3 convolutions'
work is counted call by call (`ConvWork`): FLOPs 2 * 27 * Ci * Co * R^3 * B
for the forward, the input gradient and the weight gradient alike, bytes
as each operand read once and each result written once.
"""
from __future__ import annotations

import json
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
aten = torch.ops.aten


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def conv_flops(x_shape, w_shape, y_shape) -> int:
    """2 x (multiply-adds) of one N-d convolution (channels first)."""
    taps = 1
    for k in w_shape[2:]:
        taps *= k
    out = 1
    for s in y_shape:
        out *= s
    return 2 * out * w_shape[1] * taps


class ConvWork(TorchDispatchMode):
    """Counts the convolutions run inside it: `flops`, `bytes` and
    `least_s`, the sum over calls of max(flops / peak, bytes / bandwidth)
    (each pass of a backward counted on its own)."""

    def __init__(self):
        super().__init__()
        self.flops, self.bytes, self.least_s, self.calls = 0, 0, 0.0, 0

    def _add(self, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        self.least_s += max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        self.calls += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is aten.convolution.default:
            x, w = args[0], args[1]
            self._add(conv_flops(x.shape, w.shape, out.shape),
                      _bytes(x, w, out))
        elif func is aten.convolution_backward.default:
            g, x, w = args[0], args[1], args[2]
            mask = args[-1]
            f = conv_flops(x.shape, w.shape, g.shape)
            if mask[0]:
                self._add(f, _bytes(g, w, out[0]))
            if mask[1]:
                self._add(f, _bytes(g, x, out[1]))
        return out


def count(fn: Callable[[], None]) -> Dict[str, float]:
    """Run fn (the reference's work of one unit, on the meta device) under
    both counters -> {model_flops, conv_flops, conv_bytes, conv_least_s}."""
    convs = ConvWork()
    flops = FlopCounterMode(display=False)
    with flops, convs:
        fn()
    return {"model_flops": float(flops.get_total_flops()),
            "conv_flops": float(convs.flops),
            "conv_bytes": float(convs.bytes),
            "conv_least_s": convs.least_s, "conv_calls": convs.calls}


def unit_work(cfg: dict, mix: dict) -> Dict[str, float]:
    """The work of one request or step of `mix` on configuration `cfg`,
    counted on the meta device (no memory, no device)."""
    from .reference import work_of
    return count(work_of(cfg, mix, "meta"))


if __name__ == "__main__":  # python -m benchmark.work CONFIG.json MIX.json
    import sys
    cfg = json.load(open(sys.argv[1]))["cfg"]
    mix = json.load(open(sys.argv[2]))
    print(unit_work(cfg, mix))
