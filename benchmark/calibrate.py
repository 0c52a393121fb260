"""The readings the check's limits are set from: the numbers `correct`
compares, for many seeds in one process, of the program as the
configuration states it, of the control (the family's `CONTROL`: for LION
the program's own bf16 path, `tpu.bf16`, the nearest precision below the
configuration's float32) or of a planted fault (the family's `FAULTS`).

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3
        [--control] [--fault NAME] [--seconds S]

Each seed is a whole run of the cell (weights, inputs, set-up, a window of
`--seconds`, the check) without tracing; one JSON line a seed on standard
output.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=0.001)
    args = ap.parse_args()
    from benchmark.harness import cell_of, family_of, manifest, run_cell
    _, conf, mix = cell_of(manifest(), args.workload)
    family = family_of(conf)
    keys = family.CONTROL if args.control else {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = family.FAULTS[args.fault](mix["kind"]) if args.fault else \
            contextlib.nullcontext()
        t = time.perf_counter()
        with ctx:
            r = run_cell(args.workload, seed, args.seconds, False,
                         keys=keys, readings=True)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": args.control, "fault": args.fault,
                           "seconds": time.perf_counter() - t,
                           "readings": r["readings"],
                           "metrics": r["metrics"],
                           "check_s": r["check_s"]})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
