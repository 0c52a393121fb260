"""The formulas that several per-layer metrics share, one per family; each
`metrics/<name>.py` of a family reads its own cell's run through one of
them (`BENCHMARK.json` routes each metric to its cells). A formula that
finds nothing to read returns None, and the metric is left out."""
from benchmark.work import PEAK_FP32_FLOPS


def conv_roofline(w):
    """The 3x3x3 convolutions' least time on the H100 (per call the larger
    of FLOPs / 67 TFLOP/s and bytes / 3.35 TB/s, counted from the reference
    at the cell's shapes: forward, input and weight gradients) over the
    device time of every kernel that computed them in the traced units
    (K4, K10, K8, cuDNN), in %."""
    tr = w.get("trace")
    if not tr or tr["conv_s"] <= 0:
        return None
    return 100.0 * w["work_of_unit"]["conv_least_s"] * tr["units"] \
        / tr["conv_s"]


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
