"""The formulas that several per-layer metrics share, one per kind of
metric; each `metrics/<name>.py` reads its own cell's run through one of
them (`BENCHMARK.json` routes each metric to its cells). A formula that
finds nothing to read returns None, and the metric is left out."""
from benchmark.trace import CONV_GROUPS
from benchmark.work import PEAK_FP32_FLOPS


def roofline(w, least_key: str, groups):
    """A kernel group's share of its roofline, in %: the least time on the
    H100 of a unit's work as the work counters give it (`least_key` of
    `work_of_unit`, per call the larger of FLOPs / 67 TFLOP/s and bytes /
    3.35 TB/s, counted from the reference at the cell's shapes) times the
    traced units, over the device time of the kernel groups `groups` in
    those units."""
    tr, work = w.get("trace"), w.get("work_of_unit")
    if not tr or not work or least_key not in work:
        return None
    busy = sum(v for k, v in tr["group_s"].items() if k in groups)
    if busy <= 0:
        return None
    return 100.0 * work[least_key] * tr["units"] / busy


def conv_roofline(w):
    """The 3x3x3 convolutions (forward, input and weight gradients) over
    every kernel that computed them (K4, K10, K10's weight gradient, K8,
    cuDNN)."""
    return roofline(w, "conv_least_s", CONV_GROUPS)


def idle_share(w):
    """The traced units' time with no device activity (kernels, copies,
    sets) on the trace's timeline, over that time, in %."""
    tr = w.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(w):
    """The model FLOPs of a unit (counted from the reference by
    torch.utils.flop_counter: matrix products and convolutions, forward for
    sampling, forward and backward for training) times the units the window
    completed, over the window's time and the H100's 67 TFLOP/s fp32,
    in %."""
    work = w.get("work_of_unit")
    if not work:
        return None
    return 100.0 * work["model_flops"] * w["unit_rate"] / PEAK_FP32_FLOPS
