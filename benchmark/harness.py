"""The benchmark's harness, driven by `BENCHMARK.json`: it finds a cell's
configuration (`configs/<config>.json`), its model family
(`families/<family>.py`, named in the configuration file), traffic mix
(`mixes/<traffic>.json`) and metric readers (`metrics/<metric>.py`) by the
names the manifest and the files give, runs the cell once and returns the
result line. Nothing here belongs to one cell or one family: the family
makes the weights, the traffic and the check (`families/__init__.py`).

One run: weights and inputs from the seed, the system under test built and
warmed up (set-up), the measured window, with `--trace 1` a profiled
stretch of further units and the per-layer host-clock windows, then the
program's state freed and the check of `correct` against the plain
reference. The readers turn what the run recorded (`Window`) into metrics;
a reader that finds nothing returns None and the metric is left out.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lion_tpu")
# the directories a cell's mixes, families and metric readers are looked up
# in, in order (the CPU tests put a directory of their own first)
DIRS = (BENCH,)


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(sub: str, name: str, dirs=DIRS) -> Optional[Path]:
    """The first dirs[i]/sub/name that exists, else None."""
    for d in dirs:
        path = Path(d) / sub / name
        if path.exists():
            return path
    return None


def _load(path: Path, prefix: str, name: str):
    """The module of a file, loaded by path as `<prefix>_<name>`."""
    mod_name = f"{prefix}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(man: dict, workload: str, dirs=DIRS):
    """(cell, configuration entry, mix) of a workload name."""
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    path = find("mixes", f"{cell['traffic']}.json", dirs)
    if path is None:
        raise SystemExit(f"no mix file for traffic {cell['traffic']!r} of "
                         f"workload {workload!r}")
    return cell, conf, json.loads(path.read_text())


def config_file(conf: dict, root: Path = ROOT) -> dict:
    """The whole configuration file of a configuration entry."""
    return json.loads((root / conf["file"]).read_text())


def config_of(conf: dict, root: Path = ROOT) -> dict:
    """The configuration tree (a plain nested dict) a configuration file
    holds under "cfg"."""
    return config_file(conf, root)["cfg"]


def load_family(name: str, dirs=DIRS):
    """The module of families/<name>.py; an unknown family exits."""
    path = find("families", f"{name}.py", dirs)
    if path is None:
        known = sorted({p.stem for d in dirs
                        for p in (Path(d) / "families").glob("*.py")
                        if p.stem != "__init__"})
        raise SystemExit(f"unknown family {name!r}; known: {known}")
    return _load(path, "benchmark_family", name)


def family_of(conf: dict, root: Path = ROOT, dirs=DIRS):
    """The family module of a configuration entry: the file's "family"
    key, `lion` where it has none."""
    return load_family(config_file(conf, root).get("family", "lion"), dirs)


def reference_path(family) -> Path:
    """The path of a family's plain reference (`REFERENCE`)."""
    return Path(family.__file__).resolve().parents[1] / family.REFERENCE


def set_keys(cfg: dict, keys: Dict[str, object]) -> dict:
    """A copy of cfg with dotted keys set (the CPU tests' small sizes, the
    control's bf16)."""
    cfg = json.loads(json.dumps(cfg))
    for key, value in keys.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        if leaf not in node:
            raise KeyError(key)
        node[leaf] = value
    return cfg


def metrics_for(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without
    tracing, the per-layer ones with it, each where its `workloads` (if
    given) name the cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in man[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, dirs=DIRS):
    """The `read(window)` function of metrics/<name>.py."""
    path = find("metrics", f"{name}.py", dirs)
    if path is None:
        raise SystemExit(f"no reader for metric {name!r}")
    return _load(path, "benchmark_metric", name).read


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (`lion_tpu_torch` is not `lion_tpu`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """Linear interpolation between order statistics (numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_numbers(t0: float, recs) -> Dict:
    """Rate and tail of a window: all the work over all its time, from its
    start to the end of its last unit; the tail over every unit."""
    end = max(r[1] for r in recs)
    window_s = end - t0
    return {"window_s": window_s, "units": len(recs),
            "rate": sum(r[2] for r in recs) / window_s,
            "unit_rate": len(recs) / window_s,
            "p95_s": percentile([r[1] - r[0] for r in recs], 0.95),
            "stage_seconds": [r[3] for r in recs if r[3] is not None]}


def setup_parts(t_start: float, marks: Dict[str, float]) -> Dict:
    """Seconds of each part of set-up, in the order the marks were set."""
    out, prev = {}, t_start
    for name, t in sorted(marks.items(), key=lambda kv: kv[1]):
        out[name] = round(t - prev, 4)
        prev = t
    return out


def alloc_retries(device) -> Optional[int]:
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.memory_stats(device).get("num_alloc_retries", 0))


def device_info(device, chips: int) -> Dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def trace_units(traffic, units: int, groups=None) -> Dict:
    """Profile `units` further units of the traffic and reduce the trace
    (`groups`: the family's kernel groups)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from .trace import events_of, reduce
    acts = [ProfilerActivity.CPU]
    if torch.device(traffic.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            traffic.traced(units)
    dev, host = events_of(prof)
    span = [(s, e) for n, s, e in host if n == "bench.traced"]
    lo, hi = span[0]
    # the device may still run the last unit's work after the host's range
    hi = max([hi] + [e for _, s, e in dev if s >= lo])
    out = reduce(dev, host, lo, hi, groups=groups)
    out["units"] = units
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", keys: Optional[Dict] = None,
             t_start: Optional[float] = None,
             readings: bool = False, man: Optional[dict] = None,
             dirs=DIRS) -> Dict:
    """One run of a cell -> the result line's object, `checks` last.
    `keys` sets configuration keys (CPU tests: small sizes; the control:
    the family's `CONTROL`); `readings` adds every number the check
    computed and its seconds (`readings`, `check_s`); `man` and `dirs`
    stand in for BENCHMARK.json and the benchmark's directory (the CPU
    tests' own family). `diag` holds what explains a run's numbers and is
    not one of them: each part of set-up in seconds, the window's start
    and end by the wall clock, the host's mean time to issue a training
    step, the allocator's retries in the window."""
    from lion_tpu_torch.ops import KERNELS, reset_counts
    from lion_tpu_torch.ops._cuda import library
    from .traffic import sub_seed, sync
    from .work import unit_work
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest() if man is None else man
    cell, conf, mix = cell_of(man, workload, dirs)
    family = family_of(conf, dirs=dirs)
    if mix["kind"] not in family.KINDS:
        raise SystemExit(f"the family of {conf['name']!r} has no traffic "
                         f"kind {mix['kind']!r}; known: "
                         f"{sorted(family.KINDS)}")
    marks = {"import": time.perf_counter()}
    cfg = set_keys(config_of(conf), keys or {})
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        marks["context"] = time.perf_counter()
        library()
        marks["kernels"] = time.perf_counter()
    state = family.make_weights(cfg, sub_seed(seed, 0), device)
    sync(device)
    marks["weights"] = time.perf_counter()
    traffic = family.KINDS[mix["kind"]](family.port_config(cfg), cfg, mix,
                                        state, seed, device)
    reset_counts()
    traffic.setup()
    marks.update(traffic.marks)
    marks["warm-up"] = time.perf_counter()
    setup_s = marks["warm-up"] - t_start
    plain0 = sum(k.plain_calls for k in KERNELS.values())
    retries0 = alloc_retries(device)
    wall0 = time.time()
    t0, recs = traffic.window(seconds)
    diag = {"setup_parts": setup_parts(t_start, marks),
            "window_wall": [wall0, wall0 + max(r[1] for r in recs) - t0]}
    if traffic.issue_s:
        diag["issue_ms"] = 1e3 * sum(traffic.issue_s) / len(traffic.issue_s)
    if retries0 is not None:
        # the caching allocator's frees and retries sync the device
        diag["alloc_retries"] = alloc_retries(device) - retries0
        diag["reserved_peak_bytes"] = torch.cuda.max_memory_reserved(device)
    w = {"mix": mix, "setup_s": setup_s, **window_numbers(t0, recs)}
    plain = sum(k.plain_calls for k in KERNELS.values()) - plain0
    failed = traffic.failed()
    dev_info = device_info(device, cell["chips"])
    if trace:
        w["trace"] = trace_units(traffic, mix["trace_units"],
                                 getattr(family, "GROUPS", None))
        w["layer"] = traffic.layer_windows()
        w["work_of_unit"] = unit_work(cfg, mix, family)
        dev_info["busy_s"] = w["trace"]["busy_s"]
        dev_info["window_s"] = w["trace"]["window_s"]
    rng = random.Random(seed)
    keep = sorted(rng.sample(range(w["units"]),
                             min(mix.get("check_requests", 0), w["units"])))
    kept = traffic.release(keep)
    del traffic
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = family.check(cfg, mix, state, kept, device)
    check_s = time.perf_counter() - t_check
    # a kernel wrapper's plain version may not run in the window: on the
    # card it would mean work left the kernels (on the CPU the plain
    # versions are the program's own path, so nothing is counted there)
    numbers["plain_calls"] = float(plain) \
        if torch.device(device).type == "cuda" else 0.0
    limits = mix["limits"]
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": lim}
              for k, lim in limits.items()}
    correct = bool(checks) and failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in metrics_for(man, workload, trace):
        value = reader(m["name"], dirs)(w)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": w["units"], "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": w["trace"]["device_ops"],
                               "idle_gaps": w["trace"]["idle_gaps"]}
    if readings:
        result["readings"], result["check_s"] = numbers, check_s
    result["diag"] = diag
    result["checks"] = checks
    return result

