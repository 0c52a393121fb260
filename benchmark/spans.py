"""The profiled units' device time, idle time and launches by the program's
spans.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>
        --trace 1

from the root of a checkout runs `benchmark/run.py` as it is, with its
profiled units also reduced by span: standard error gains one `spans:`
line, a JSON object with the table (a span path: count, device_s, idle_s,
launches, its top kernel groups), the coverage and the per-layer numbers
that read the table (`span_metrics`).

The program's spans (`lion_tpu_torch/utils/spans.py`) are user
annotations in the trace, on the clock of the kernels and the CUDA runtime
calls. A span's key is its path from the outermost program span
(`sample/sample.local/chain.prior`); `bench.traced`, the harness's range,
is not a program span. Each kernel, copy and set is put down to the
innermost program span open at the start of the runtime call that launched
it, found by correlation id, whatever thread made the call: autograd's
backward launches from its own thread, inside the main thread's
`train.backward`. Each idle gap of the device is put down to the innermost
span open when it begins, which is what the host was doing then: a gap
that begins once the host has moved on to a later phase counts there.
Launch calls are counted by the span open at their start. Work outside
every span is `outside`; a device event whose launching call is not in the
trace is `unmatched`.
"""
from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.trace import gaps, group  # noqa: E402

PROGRAM_SPANS = frozenset((
    "sample", "sample.global", "sample.local", "sample.decode",
    "chain.prior", "chain.update", "train.step", "train.forward",
    "train.backward", "train.update", "prior.encode"))
LAUNCHES = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"))
OUTSIDE, UNMATCHED = "outside", "unmatched"
STAGES = {"sample": ("sample.global", "sample.local", "sample.decode"),
          "train": ("train.forward", "train.backward", "train.update")}


def span_events(prof):
    """(spans, calls, device) of a finished torch.profiler.profile, on the
    clock of `trace.events_of` (seconds from the trace's first event):
    spans [(name, start, end)] the program's ranges on the host, calls
    [(name, start, correlation id)] the CUDA API calls (cuda*, cu*),
    device [(name, start, end, correlation id)] the kernels, copies and
    sets (not the host ranges the profiler also draws there)."""
    evs = list(prof.profiler.kineto_results.events())
    base = min((ev.start_ns() for ev in evs), default=0)
    ranges = {ev.name() for ev in evs if ev.is_user_annotation()}
    spans, calls, device = [], [], []
    for ev in evs:
        start = (ev.start_ns() - base) * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if str(ev.device_type()).endswith("CUDA"):
            if not (ev.is_user_annotation() or ev.name() in ranges):
                device.append((ev.name(), start, end, ev.correlation_id()))
        elif ev.is_user_annotation():
            if ev.name() in PROGRAM_SPANS:
                spans.append((ev.name(), start, end))
        elif ev.name().startswith("cu"):
            # a CUDA API call (cudaLaunchKernel, cuLaunchKernel, ...); the
            # host's ops are named aten::*, autograd::* and the like
            calls.append((ev.name(), start, ev.correlation_id()))
    return spans, calls, device


class SpanTree:
    """Nested spans [(name, start, end)]: each one's path and the
    innermost span open at a time."""

    def __init__(self, spans: List[Tuple[str, float, float]]):
        self.starts, self.ends, self.paths, self.parents = [], [], [], []
        open_ = []
        for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
            while open_ and self.ends[open_[-1]] <= s:
                open_.pop()
            parent = open_[-1] if open_ else -1
            self.paths.append(name if parent < 0
                              else f"{self.paths[parent]}/{name}")
            self.starts.append(s)
            self.ends.append(e)
            self.parents.append(parent)
            open_.append(len(self.paths) - 1)

    def at(self, t: float) -> str:
        """The path of the innermost span open at t, or OUTSIDE."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] <= t:
            i = self.parents[i]
        return self.paths[i] if i >= 0 else OUTSIDE


def by_span(spans, calls, device, lo: float, hi: float,
            top: int = 5) -> Dict[str, Dict]:
    """The traced window [lo, hi] by span path: count (spans that start in
    it), device_s (device time of the kernels, copies and sets it
    launched, clipped to the window), idle_s (the device's idle gaps that
    begin in it), launches (launch calls) and groups (device time by
    `trace.group`, largest `top` first)."""
    tree = SpanTree(spans)
    launched_at = {c: s for _, s, c in calls}
    table: Dict[str, Dict] = {}

    def row(path):
        return table.setdefault(path, {"count": 0, "device_s": 0.0,
                                       "idle_s": 0.0, "launches": 0,
                                       "groups": {}})

    for path, s in zip(tree.paths, tree.starts):
        if lo <= s <= hi:
            row(path)["count"] += 1
    inside = [(n, max(s, lo), min(e, hi), c) for n, s, e, c in device
              if e > lo and s < hi]
    for n, s, e, c in inside:
        t = launched_at.get(c)
        r = row(UNMATCHED if t is None else tree.at(t))
        r["device_s"] += e - s
        g = group(n)
        r["groups"][g] = r["groups"].get(g, 0.0) + (e - s)
    for s, e in gaps([(s, e) for _, s, e, _ in inside], lo, hi):
        row(tree.at(s))["idle_s"] += e - s
    for name, s, _ in calls:
        if name in LAUNCHES and lo <= s <= hi:
            row(tree.at(s))["launches"] += 1
    for r in table.values():
        r["groups"] = [[k, v] for k, v in sorted(
            r["groups"].items(), key=lambda kv: -kv[1])[:top]]
    return table


def total(table, key: str, within: Optional[str] = None,
          last: Optional[str] = None) -> float:
    """`key` summed over the paths that pass through the span `within` and
    end in the span `last` (either may be None: any)."""
    out = 0
    for path, r in table.items():
        names = path.split("/")
        if path in (OUTSIDE, UNMATCHED) and (within or last):
            continue
        if (within is None or within in names) and \
                (last is None or names[-1] == last):
            out += r[key]
    return out


def coverage(kind: str, table) -> Dict[str, float]:
    """Shares of the units' device time launched outside every program
    span, unmatched, and under the mix's stage spans (`STAGES`)."""
    dev = total(table, "device_s")
    if dev <= 0:
        return {}
    stages = STAGES["sample" if kind == "sample" else "train"]
    return {"outside_share": table.get(OUTSIDE, {}).get("device_s", 0) / dev,
            "unmatched_share":
                table.get(UNMATCHED, {}).get("device_s", 0) / dev,
            "stage_share": sum(total(table, "device_s", s)
                               for s in stages) / dev}


def span_metrics(kind: str, table) -> Dict[str, float]:
    """The per-layer numbers that read the table; a step is one of the
    local chain's `chain.prior` spans (sampling) or one `train.step`
    (training). Empty where the program has no such span."""
    ms = 1e3
    if kind == "sample":
        steps = total(table, "count", "sample.local", "chain.prior")
        if not steps:
            return {}
        return {
            "sample.local_prior_device_ms_per_step": ms * total(
                table, "device_s", "sample.local", "chain.prior") / steps,
            "sample.local_update_device_ms_per_step": ms * total(
                table, "device_s", "sample.local", "chain.update") / steps,
            "sample.local_idle_ms_per_step":
                ms * total(table, "idle_s", "sample.local") / steps,
            "sample.local_launches_per_step":
                total(table, "launches", "sample.local") / steps}
    steps = total(table, "count", last="train.step")
    if not steps:
        return {}
    pre = "vae_train" if kind == "train_vae" else "prior_train"
    out = {
        f"{pre}.backward_device_ms":
            ms * total(table, "device_s", "train.backward") / steps,
        f"{pre}.update_device_ms":
            ms * total(table, "device_s", "train.update") / steps,
        f"{pre}.forward_idle_ms":
            ms * total(table, "idle_s", "train.forward") / steps,
        f"{pre}.backward_idle_ms":
            ms * total(table, "idle_s", "train.backward") / steps,
        f"{pre}.launches_per_step":
            total(table, "launches", "train.step") / steps}
    if kind == "train_prior":
        out["prior_train.encode_device_ms"] = \
            ms * total(table, "device_s", "prior.encode") / steps
    return out


def trace_units_by_span(traffic, units: int, groups=None) -> Dict:
    """`harness.trace_units` (the same profile, window and reduction), with
    the trace also reduced by span (`spans`), written to standard error."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark.trace import events_of, reduce
    acts = [ProfilerActivity.CPU]
    if torch.device(traffic.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            traffic.traced(units)
    dev, host = events_of(prof)
    span = [(s, e) for n, s, e in host if n == "bench.traced"]
    lo, hi = span[0]
    hi = max([hi] + [e for _, s, e in dev if s >= lo])
    out = reduce(dev, host, lo, hi, groups=groups)
    out["units"] = units
    table = by_span(*span_events(prof), lo, hi)
    kind = traffic.mix["kind"]
    out["spans"] = table
    print("spans: " + json.dumps(
        {"units": units, "table": table, "coverage": coverage(kind, table),
         "metrics": span_metrics(kind, table)}), file=sys.stderr)
    return out


if __name__ == "__main__":
    from benchmark import harness, run
    harness.trace_units = trace_units_by_span
    sys.exit(run.main())
