"""Reduction of a torch.profiler trace to the device's busy time, its idle
gaps and its time by kernel group.

Busy time is the union of the device's activity intervals (kernels,
copies, sets) on the trace's own timeline, inside the traced window: the
profiler's host overhead widens the window's idle gaps, never the busy
time. Kernel groups are the port's kernel names (csrc/*.cu), then the
family's own patterns (`GROUPS` of its family file), then the library
kernels' families. An idle gap is labelled with the host event
that began most recently before it (what the host was doing while the
device waited).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

# the port's __global__ kernel names -> its wrappers (kernel numbers as the
# port's documents give them)
OURS = {"fps_kernel": "K1 fps", "bqg_kernel": "K2 ball_query_group",
        "vox_order_kernel": "K3 avg_voxelize",
        "vox_mean_kernel": "K3 avg_voxelize",
        "conv3d_brick": "K4 conv3d_3x3_fused",
        "devox_kernel": "K5 trilinear_devoxelize",
        "three_nn_kernel": "K6 three_nn_interpolate",
        "sa_pass_kernel": "K7 sa_fused",
        "pair_conv0_brick": "K8 conv3d_pair",
        "pair_conv1_brick": "K8 conv3d_pair",
        "pair_fold_kernel": "K8 conv3d_pair",
        "pvblock_brick": "K9 pvconv_block_pair",
        "bq_kernel": "K11 ball_query",
        "row_order_kernel": "row_sum", "row_sum_kernel": "row_sum",
        "k10_wgrad_tile": "K10 wgrad", "k10_wgrad_sum": "K10 wgrad",
        "bqg_cf_kernel": "K13 ball_query_group_cf",
        "emd_": "K12 emd_cost"}
# the brick kernel without statistics is the training conv (K10)
K10 = ("conv3d_brick_f32<", "conv3d_brick_bf16<")
# groups whose kernels compute the 3x3x3 convolutions
CONV_GROUPS = ("K4 conv3d_3x3_fused", "K10 conv3d_3x3_same",
               "K8 conv3d_pair", "K10 wgrad", "cuDNN wgrad", "cuDNN other")


def group(name: str, groups: Optional[Dict[str, str]] = None) -> str:
    """The group of a kernel name; `groups` (a family's kernel-name
    substrings -> labels) is tried after the port's names and before the
    library kernels' families."""
    if any(k in name for k in K10) and ", false>" in name:
        return "K10 conv3d_3x3_same"
    for table in (OURS, groups or {}):
        for k, v in table.items():
            if k in name:
                return v
    low = name.lower()
    if "wgrad" in low:
        return "cuDNN wgrad"
    if any(k in low for k in ("dgrad", "fprop", "conv", "cudnn")):
        return "cuDNN other"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer + EMA (foreach)"
    if "scatter" in low or "gather" in low or "index" in low:
        return "torch scatter/gather"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma")):
        return "cuBLAS matmul"
    if "reduce" in low:
        return "torch reductions"
    if "memcpy" in low or "memset" in low:
        return "copies and sets"
    if "elementwise" in low or "vectorized" in low:
        return "torch elementwise"
    return "torch other"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """The idle stretches of [lo, hi] between the intervals."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(device_events, host_events, lo: float, hi: float,
           top: int = 10, groups: Optional[Dict[str, str]] = None) -> Dict:
    """device_events / host_events: [(name, start_s, end_s)] on one clock;
    [lo, hi] the traced window; `groups` the family's kernel groups. ->
    busy_s, window_s, group_s (the device time of every group, in the
    order first seen), conv_s (the device time of the 3x3x3 convolutions'
    kernels), device_ops (the `top` groups, largest first) and idle_gaps
    (idle time by the host's latest event)."""
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events
              if e > lo and s < hi]
    busy = union_length([(s, e) for _, s, e in inside])
    by_group: Dict[str, float] = {}
    for n, s, e in inside:
        g = group(n, groups)
        by_group[g] = by_group.get(g, 0.0) + (e - s)
    host = sorted((s, n) for n, s, e in host_events)
    starts = [s for s, _ in host]
    idle: Dict[str, float] = {}
    for s, e in gaps([(s, e) for _, s, e in inside], lo, hi):
        i = bisect.bisect_right(starts, s) - 1
        label = host[i][1] if i >= 0 else "before the first host event"
        idle[label] = idle.get(label, 0.0) + (e - s)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
    return {"busy_s": busy, "window_s": hi - lo, "group_s": by_group,
            "conv_s": sum(v for k, v in by_group.items()
                          if k in CONV_GROUPS),
            "device_ops": [[k, v] for k, v in order(by_group)[:top]],
            "idle_gaps": [[k, v] for k, v in order(idle)[:top]]}


def events_of(prof):
    """(device events, host events) of a finished torch.profiler.profile,
    each [(name, start_s, end_s)] on the trace's clock: on the device its
    kernels, copies and sets, not the host's ranges that the profiler also
    draws there."""
    evs = list(prof.profiler.kineto_results.events())
    base = min((ev.start_ns() for ev in evs), default=0)
    ranges = {ev.name() for ev in evs if ev.is_user_annotation()}
    dev, host = [], []
    for ev in evs:
        start = (ev.start_ns() - base) * 1e-9
        end = start + ev.duration_ns() * 1e-9
        on_device = str(ev.device_type()).endswith("CUDA")
        if on_device and (ev.is_user_annotation() or ev.name() in ranges):
            continue   # a host range drawn on the device's timeline
        (dev if on_device else host).append((ev.name(), start, end))
    return dev, host
