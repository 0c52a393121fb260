"""The port's spans (`lion_tpu_torch/utils/spans.py`) and the benchmark's
reduction of a profiler trace by span (`benchmark/spans.py`), on the CPU.

Under a CPU profiler a tiny `LION.sample` and tiny stage-1 and two-prior
steps open their spans in the documented nesting; outputs, losses and
parameters are the same with the profiler as without it, and without one
no range is opened. The reduction is held to synthetic events: a kernel
launched from autograd's thread inside `train.backward` that runs after
the host has moved on, an idle gap put down to the host's span at its
start, the launches and `outside`.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.spans import (OUTSIDE, UNMATCHED, SpanTree, by_span, coverage,
                             span_events, span_metrics)
from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models import LION
from lion_tpu_torch.models.vae import VAE
from lion_tpu_torch.nn import init_weights
from lion_tpu_torch.trainers import make_prior_train_step, make_vae_train_step
from lion_tpu_torch.utils import spans as port_spans

from test_torch_port_sample import one_torch_thread, tiny_cfg  # noqa: F401
from test_torch_port_train import B, N, noise, train_cfg
from test_torch_port_vae_train import vae_cfg

DDIM = 3
STEPS = 5            # tiny_cfg's ddpm.num_steps


def _sample(ddim_step):
    lion = LION(tiny_cfg(get_default_cfg()), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    out = lion.sample(B, generator=torch.Generator().manual_seed(1),
                      ddim_step=ddim_step)
    return [out["z_global"], out["z_local"], out["points"]]


def _step(kind):
    """Two steps of a fresh tiny step object -> losses and parameters."""
    gen = torch.Generator().manual_seed(2)
    if kind == "vae":
        vae = VAE(vae_cfg(get_default_cfg()))
        init_weights(vae, torch.Generator().manual_seed(3))
        step = make_vae_train_step(vae, lambda i: 1e-3, device="cpu")
    else:
        cfg = train_cfg(get_default_cfg())
        cfg.sde.dropout = 0.2
        lion = LION(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(3))
        step = make_prior_train_step(lion, lambda i: 1e-3, device="cpu")
    x = torch.from_numpy(noise(4, B, N, 3, scale=0.3))
    losses = [step(x, gen)["loss"] for _ in range(2)]
    return losses + [p.detach().clone() for p in step.params]


RUNS = {"ddim": lambda: _sample(DDIM), "ancestral": lambda: _sample(0),
        "vae": lambda: _step("vae"), "prior": lambda: _step("prior")}
_DONE = {}


def traced(case):
    """(outputs without a profiler, outputs under one, span path counts)."""
    if case not in _DONE:
        plain = RUNS[case]()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            under = RUNS[case]()
        spans, _, _ = span_events(prof)
        _DONE[case] = plain, under, Counter(SpanTree(spans).paths)
    return _DONE[case]


def test_sample_spans_nest_under_each_stage():
    paths = traced("ddim")[2]
    chain = {"chain.prior": DDIM, "chain.update": DDIM}
    assert paths == Counter({
        "sample": 1, "sample/sample.global": 1, "sample/sample.local": 1,
        "sample/sample.decode": 1,
        **{f"sample/{s}/{c}": n for s in ("sample.global", "sample.local")
           for c, n in chain.items()}})


def test_ancestral_steps_nest_the_prior_in_the_step():
    paths = traced("ancestral")[2]
    for stage in ("sample.global", "sample.local"):
        assert paths[f"sample/{stage}/chain.update"] == STEPS
        assert paths[f"sample/{stage}/chain.update/chain.prior"] == STEPS
    assert sum(paths.values()) == 4 + 4 * STEPS


@pytest.mark.parametrize("kind", ["vae", "prior"])
def test_train_step_spans_nest(kind):
    paths = traced(kind)[2]
    want = {"train.step": 2, "train.step/train.forward": 2,
            "train.step/train.backward": 2, "train.step/train.update": 2}
    if kind == "prior":
        want["train.step/train.forward/prior.encode"] = 2
    assert paths == Counter(want)


@pytest.mark.parametrize("case", ["ddim", "ancestral", "vae", "prior"])
def test_the_profiler_changes_no_number(case):
    plain, under, _ = traced(case)
    assert len(plain) == len(under)
    assert all(torch.equal(a, b) for a, b in zip(plain, under))


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name} opened without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    _sample(DDIM)
    _step("prior")
    with port_spans.span("x") as s:
        pass
    assert s.seconds >= 0.0


def test_stage_seconds_read_the_stage_spans(monkeypatch):
    """On a clock that ticks once a read, a stage's seconds are the reads
    inside its span plus one: two a chain span, none in the decode."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(port_spans.time, "perf_counter",
                        lambda: float(next(ticks)))
    lion = LION(tiny_cfg(get_default_cfg()), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    out = lion.sample(B, generator=torch.Generator().manual_seed(1),
                      ddim_step=DDIM)
    chain = 1 + 2 * 2 * DDIM
    assert out["stage_seconds"] == {"global": chain, "local": chain,
                                    "decode": 1}


# ------------------------------------------------ the reduction by span
STEP_SPANS = [("train.step", 0.0, 10.0), ("train.forward", 0.5, 3.0),
              ("train.backward", 3.0, 6.0), ("train.update", 6.0, 9.5)]
CALLS = [("cudaLaunchKernel", 1.0, 1),     # the forward's kernel
         ("cudaLaunchKernel", 4.0, 2),     # autograd's thread, backward
         ("cudaMemcpyAsync", 5.0, 5),      # a backward copy: no launch
         ("cuLaunchKernel", 7.0, 3),       # Adam
         ("cudaLaunchKernel", 10.5, 4)]    # after the step
DEVICE = [("k_fwd", 1.2, 2.0, 1),
          ("sm90_xmma_wgrad_kernel", 6.5, 7.5, 2),   # runs in the update
          ("Memcpy DtoD", 7.6, 7.8, 5),
          ("multi_tensor_apply_kernel", 8.0, 8.5, 3),
          ("late", 10.6, 11.0, 4),
          ("orphan", 11.0, 11.5, 99)]      # its call is not in the trace


def _table():
    return by_span(STEP_SPANS, CALLS, DEVICE, 0.0, 12.0)


def test_a_kernel_counts_for_the_span_that_launched_it():
    t = _table()
    bwd = t["train.step/train.backward"]
    assert bwd["device_s"] == pytest.approx(1.0 + 0.2)
    assert dict(bwd["groups"]) == pytest.approx(
        {"cuDNN wgrad": 1.0, "copies and sets": 0.2})
    assert t["train.step/train.forward"]["device_s"] == pytest.approx(0.8)
    assert t["train.step/train.update"]["device_s"] == pytest.approx(0.5)
    assert t[UNMATCHED]["device_s"] == pytest.approx(0.5)


def test_a_gap_counts_for_the_hosts_span_at_its_start():
    t = _table()
    assert t["train.step"]["idle_s"] == pytest.approx(1.2)     # [0, 1.2)
    # [2.0, 6.5): begun in the forward, though it lasts into the update
    assert t["train.step/train.forward"]["idle_s"] == pytest.approx(4.5)
    assert t["train.step/train.backward"]["idle_s"] == 0.0
    # [7.5, 7.6), [7.8, 8.0), [8.5, 10.6)
    assert t["train.step/train.update"]["idle_s"] == pytest.approx(2.4)
    assert t[OUTSIDE]["idle_s"] == pytest.approx(0.5)          # [11.5, 12)


def test_launches_counts_and_outside():
    t = _table()
    assert {p: r["launches"] for p, r in t.items()} == {
        "train.step": 0, "train.step/train.forward": 1,
        "train.step/train.backward": 1, "train.step/train.update": 1,
        OUTSIDE: 1, UNMATCHED: 0}
    assert {p: r["count"] for p, r in t.items() if r["count"]} == {
        "train.step": 1, "train.step/train.forward": 1,
        "train.step/train.backward": 1, "train.step/train.update": 1}
    assert t[OUTSIDE]["device_s"] == pytest.approx(0.4)
    cov = coverage("train_prior", t)
    assert cov["outside_share"] == pytest.approx(0.4 / 3.4)
    assert cov["unmatched_share"] == pytest.approx(0.5 / 3.4)
    assert cov["stage_share"] == pytest.approx(2.5 / 3.4)


def test_span_metrics_per_step():
    m = span_metrics("train_prior", _table())
    assert m == pytest.approx({
        "prior_train.backward_device_ms": 1200.0,
        "prior_train.update_device_ms": 500.0,
        "prior_train.forward_idle_ms": 4500.0,
        "prior_train.backward_idle_ms": 0.0,
        "prior_train.launches_per_step": 3.0,
        "prior_train.encode_device_ms": 0.0})
    assert set(span_metrics("train_vae", _table())) == {
        f"vae_train.{k}" for k in ("backward_device_ms", "update_device_ms",
                                   "forward_idle_ms", "backward_idle_ms",
                                   "launches_per_step")}
    # two requests of two DDIM steps, the local chain's spans
    spans = []
    for r in range(2):
        t0 = 100.0 * r
        spans += [("sample", t0, t0 + 90), ("sample.local", t0, t0 + 80)]
        for k in range(2):
            s = t0 + 40 * k
            spans += [("chain.prior", s, s + 30),
                      ("chain.update", s + 30, s + 40)]
    calls = [("cudaLaunchKernel", 5.0, 1), ("cudaLaunchKernel", 35.0, 2),
             ("cudaLaunchKernel", 85.0, 3)]
    device = [("conv3d_brick_f32<64, true>", 6.0, 26.0, 1),
              ("vectorized_elementwise_kernel", 36.0, 38.0, 2),
              ("devox_kernel", 86.0, 88.0, 3)]
    t = by_span(spans, calls, device, 0.0, 200.0)
    assert span_metrics("sample", t) == pytest.approx({
        "sample.local_prior_device_ms_per_step": 1e3 * 20.0 / 4,
        "sample.local_update_device_ms_per_step": 1e3 * 2.0 / 4,
        # [0, 6), [26, 36), [38, 86); [88, 200) begins in `sample`
        "sample.local_idle_ms_per_step": 1e3 * (6 + 10 + 48) / 4,
        "sample.local_launches_per_step": 2 / 4})
    assert span_metrics("sample", by_span([], calls, device, 0, 200)) == {}
