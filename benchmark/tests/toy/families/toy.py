"""The toy family: the two-layer MLP denoiser of `program.py`, sampled in a
closed loop, checked against `reference.py`. It gives every part of the
contract in `benchmark/families/__init__.py`, the optional ones too."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.tests.toy import program, reference
from benchmark.traffic import Traffic, sub_seed, sync
from benchmark.work import least_s

REFERENCE = "reference.py"
GROUPS = {"toy_mlp": "toy mlp"}
CONTROL = {"bf16": True}
TINY: Dict = {}
aten = torch.ops.aten


def port_config(cfg: dict) -> dict:
    return dict(cfg)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """nn.Linear's initializer, uniform in +-1/sqrt(fan_in), from one draw
    of a generator on the device."""
    h = cfg["hidden"]
    shapes = {"fc1.weight": (h, 4), "fc1.bias": (h,),
              "fc2.weight": (3, h), "fc2.bias": (3,)}
    fan_in = {"fc1": 4, "fc2": h}
    gen = torch.Generator(device=device).manual_seed(seed)
    n = sum(torch.Size(s).numel() for s in shapes.values())
    draw = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for name, shape in shapes.items():
        k = torch.Size(shape).numel()
        bound = fan_in[name.split(".")[0]] ** -0.5
        state[name] = (draw[at:at + k] * bound).reshape(shape)
        at += k
    return state


class DenoiseTraffic(Traffic):
    """Sampling requests back to back, each from its own seeded noise."""

    def setup(self):
        self.dtype = torch.bfloat16 if self.cfg["bf16"] else torch.float32
        self.model = program.Denoiser(self.cfg["hidden"]).to(self.device)
        self.model.load_state_dict(self.state, strict=True)
        self.model.to(self.dtype)
        self.mark("model")
        for i in range(self.mix["warmup_requests"]):
            self._request(-1 - i)
        self.outputs: List = []

    def request_seed(self, i: int) -> int:
        return sub_seed(self.seed, 2, i + 1000)

    def _request(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(
            self.request_seed(i))
        return program.sample(self.model, self.mix["batch"],
                              self.cfg["points"], self.mix["steps"], gen,
                              self.dtype)

    def window(self, seconds: float):
        recs, i = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            points = self._request(i)
            sync(self.device)
            recs.append((start, time.perf_counter(), self.mix["batch"],
                         None))
            self.outputs.append((i, points))
            i += 1
        return t0, recs

    def traced(self, units: int):
        for k in range(units):
            self._request(10 ** 6 + k)
        sync(self.device)

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(p).all()) for _, p in self.outputs)

    def release(self, keep: List[int]):
        kept = [{"seed": self.request_seed(self.outputs[k][0]),
                 "points": self.outputs[k][1]} for k in keep]
        self.model, self.outputs = None, []
        return kept


KINDS = {"toy_denoise": DenoiseTraffic}


def check(cfg: dict, mix: dict, state, kept, device) -> Dict[str, float]:
    """sample_gap: the largest relative L2 gap of a kept request's cloud to
    the reference's walk from the same noise."""
    gap = 0.0
    for cap in kept:
        gen = torch.Generator(device=device).manual_seed(cap["seed"])
        x = torch.randn(mix["batch"], cfg["points"], 3, generator=gen,
                        device=device)
        ref = reference.sample(state, x, mix["steps"])
        g = float((cap["points"] - ref).norm() / ref.norm())
        gap = max(gap, g if g == g else float("inf"))
    return {"sample_gap": gap}


def work_of(cfg: dict, mix: dict, device):
    """One request on the reference, with zero weights and noise."""
    h = cfg["hidden"]
    state = {"fc1.weight": torch.zeros(h, 4, device=device),
             "fc1.bias": torch.zeros(h, device=device),
             "fc2.weight": torch.zeros(3, h, device=device),
             "fc2.bias": torch.zeros(3, device=device)}

    def unit():
        x = torch.zeros(mix["batch"], cfg["points"], 3, device=device)
        reference.sample(state, x, mix["steps"])
    return unit


class MatmulWork(TorchDispatchMode):
    """The MLP's matrix products: FLOPs and their least time on the card,
    each operand read once and the result written once."""

    def __init__(self):
        super().__init__()
        self.flops, self.least_s = 0, 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (aten.mm.default, aten.addmm.default):
            a, b = args[-2], args[-1]
            flops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*args, out) if isinstance(t, torch.Tensor))
            self.flops += flops
            self.least_s += least_s(flops, nbytes)
        return out

    def numbers(self) -> Dict[str, float]:
        return {"mlp_flops": float(self.flops), "mlp_least_s": self.least_s}


COUNTERS = (MatmulWork,)


@contextlib.contextmanager
def altered(kind: str):
    """An answer altered where it is produced: every sampled cloud moved."""
    sample = program.sample

    def moved(*args, **kwargs):
        return sample(*args, **kwargs) + 0.5
    program.sample = moved
    try:
        yield
    finally:
        program.sample = sample


FAULTS = {"altered": altered}
OF_KIND = {"toy_denoise": ("altered",)}
