"""Run one cell of the benchmark of `lion_tpu_torch` once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Prints to standard error, after the run, the
card's name and power limit, what explains the run's numbers (`run:` the
parts of set-up, the window's wall-clock span, the host's issue time),
then the numbers the check of `correct` compared, each beside its limit,
and as the last line of standard output one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with --trace
1 its per-layer metrics), device, with --trace 1 breakdown, and last the
checks. Exits 2 without a result when CUDA is not available or
the machine has fewer cards than the cell asks for, and 3 when a module of
JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its kernels under build/lion_tpu_torch/ itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return out.replace("\n", "; ")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from benchmark.harness import (cell_of, forbidden_loaded, manifest,
                                   run_cell)
    cell = cell_of(manifest(), args.workload)[0]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {cards} (no fallback to the CPU)",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    # read after the run, so that set-up does not wait for nvidia-smi
    print(f"card: {card_line()}; published peaks: 67 TFLOP/s fp32, "
          f"3.35 TB/s (H100 SXM, 700 W)", file=sys.stderr)
    bad = forbidden_loaded()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    diag = result.pop("diag")
    print(f"run: {json.dumps(diag)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
