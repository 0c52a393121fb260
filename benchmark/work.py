"""The yardstick's arithmetic: the H100's published peaks and the work of
one request or step, counted from the reference at the cell's shapes.

Peaks (NVIDIA H100 SXM data sheet, dense): 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3. The model's FLOPs are what
torch.utils.flop_counter counts of the reference (matrix products and
convolutions; forward for sampling, forward and backward for training),
so the count does not move with the program. The 3x3x3 convolutions'
work is counted call by call (`ConvWork`): FLOPs 2 * 27 * Ci * Co * R^3 * B
for the forward, the input gradient and the weight gradient alike, bytes
as each operand read once and each result written once. A family adds
counters of its own (`COUNTERS`), each a `TorchDispatchMode` with a
`numbers()` method, whose numbers sit beside these.
"""
from __future__ import annotations

import contextlib
import json
from typing import Callable, Dict, Sequence

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


def least_s(flops: float, nbytes: float) -> float:
    """The least time of one call on the H100: the larger of its FLOPs at
    the fp32 peak and its bytes at the HBM bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)


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
        self.least_s += least_s(flops, nbytes)
        self.calls += 1

    def numbers(self) -> Dict[str, float]:
        return {"conv_flops": float(self.flops),
                "conv_bytes": float(self.bytes),
                "conv_least_s": self.least_s, "conv_calls": self.calls}

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


def count(fn: Callable[[], None],
          counters: Sequence[type] = ()) -> Dict[str, float]:
    """Run fn (the reference's work of one unit, on the meta device) under
    the model FLOPs' counter, the convolutions' and each of `counters` ->
    {model_flops, conv_flops, conv_bytes, conv_least_s, conv_calls} and
    every counter's numbers."""
    flops = FlopCounterMode(display=False)
    modes = [ConvWork()] + [c() for c in counters]
    with contextlib.ExitStack() as stack:
        for mode in [flops] + modes:
            stack.enter_context(mode)
        fn()
    out = {"model_flops": float(flops.get_total_flops())}
    for mode in modes:
        out.update(mode.numbers())
    return out


def unit_work(cfg: dict, mix: dict, family) -> Dict[str, float]:
    """The work of one request or step of `mix` on configuration `cfg` of
    `family`, counted on the meta device (no memory, no device)."""
    return count(family.work_of(cfg, mix, "meta"),
                 getattr(family, "COUNTERS", ()))


if __name__ == "__main__":  # python -m benchmark.work CONFIG.json MIX.json
    import sys
    from .harness import load_family
    conf = json.load(open(sys.argv[1]))
    mix = json.load(open(sys.argv[2]))
    print(unit_work(conf["cfg"], mix,
                    load_family(conf.get("family", "lion"))))
