"""Runs of one cell in processes of their own, as its bounds are measured,
with the card's clock and power read beside each run.

    python benchmark/spread.py --workload <cell> --seeds 1,2,3 [--sets 2]
        [--seconds 30] [--trace 0] [--out DIR]

For each set, for each seed, one process of `benchmark/run.py`. While it
runs, `nvidia-smi` reads the SM clock, the power draw, the temperature and
the active clock-event reasons every 500 ms (it only reads). Each run's
standard output and error go under DIR. One JSON line a run: its metrics,
`correct`, what run.py reports beside them (the parts of set-up, the
host's mean time to issue a training step) and the card's readings inside
the measured window (mean and least SM clock in MHz, mean power in W,
highest temperature, the clock-event reasons seen). Last, one line a
metric: each set's median and spread (interquartile range over the median,
`statistics.quantiles(values, n=4)`).
"""
import argparse
import json
import statistics
import subprocess
import sys
from datetime import datetime
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ["timestamp", "clocks.sm", "power.draw", "temperature.gpu"]
REASONS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")


def smi(fields, *extra):
    return ["nvidia-smi", "--query-gpu=" + ",".join(fields),
            "--format=csv,noheader,nounits", *extra]


def query_fields():
    """The fields this nvidia-smi knows: the clock-event reasons go by
    either name, or are left out."""
    for reason in REASONS + (None,):
        fields = FIELDS + ([reason] if reason else [])
        try:
            ok = subprocess.run(smi(fields), capture_output=True,
                                timeout=30).returncode == 0
        except (OSError, subprocess.SubprocessError):
            return None
        if ok:
            return fields
    return None


def card_readings(path: Path, fields, lo: float, hi: float) -> dict:
    rows = []
    for line in path.read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != len(fields):
            continue
        try:
            t = datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
        except ValueError:
            continue
        if lo <= t.timestamp() <= hi:
            rows.append(parts)

    def nums(i):
        out = []
        for r in rows:
            try:
                out.append(float(r[i]))
            except ValueError:
                pass
        return out
    if not rows:
        return {}
    sm, power, temp = nums(1), nums(2), nums(3)
    out = {"samples": len(rows)}
    if sm:
        out["sm_mhz_mean"] = statistics.fmean(sm)
        out["sm_mhz_min"] = min(sm)
    if power:
        out["power_w_mean"] = statistics.fmean(power)
    if temp:
        out["temp_c_max"] = max(temp)
    if len(fields) > 4:
        out["reasons"] = sorted({r[4] for r in rows})
    return out


def one_run(args, seed: int, tag: str, fields, out_dir: Path) -> dict:
    stem = out_dir / f"{args.workload}.{tag}.{seed}"
    cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload,
           "--seed", str(seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace)]
    with open(f"{stem}.smi", "w") as smi_out, \
            open(f"{stem}.out", "w") as out, open(f"{stem}.err", "w") as err:
        sampler = subprocess.Popen(smi(fields, "-lms", "500"),
                                   stdout=smi_out,
                                   stderr=subprocess.DEVNULL) \
            if fields else None
        try:
            rc = subprocess.run(cmd, cwd=ROOT, stdout=out, stderr=err,
                                timeout=args.timeout).returncode
        finally:
            if sampler is not None:
                sampler.terminate()
                try:
                    sampler.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    sampler.kill()
                    sampler.wait()
    rec = {"workload": args.workload, "set": tag, "seed": seed, "rc": rc}
    lines = Path(f"{stem}.out").read_text().splitlines()
    if lines and lines[-1].startswith("{"):
        res = json.loads(lines[-1])
        rec["correct"] = res["correct"]
        rec["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
        rec["memory_peak_bytes"] = res["device"]["memory_peak_bytes"]
    for line in Path(f"{stem}.err").read_text().splitlines():
        if line.startswith("run: "):
            rec["diag"] = json.loads(line[5:])
    wall = rec.get("diag", {}).get("window_wall")
    if fields and wall:
        rec["card"] = card_readings(Path(f"{stem}.smi"), fields, *wall)
    return rec


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out", default="build/spread")
    args = ap.parse_args()
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    fields = query_fields()
    seeds = [int(s) for s in args.seeds.split(",")]
    by_metric = {}
    for k in range(args.sets):
        tag = "ab"[k] if args.sets <= 2 else str(k)
        for seed in seeds:
            rec = one_run(args, seed, tag, fields, out_dir)
            print(json.dumps(rec), flush=True)
            for name, v in rec.get("metrics", {}).items():
                by_metric.setdefault(name, {}).setdefault(tag, []).append(v)
    for name, sets in by_metric.items():
        line = {"metric": name}
        for tag, vals in sets.items():
            line[tag] = {"median": statistics.median(vals),
                         "spread": spread(vals) if len(vals) > 1 else None,
                         "values": vals}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
