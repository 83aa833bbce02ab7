"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload glued.batch128 --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout.  Prints progress, the card's name, power
limit and clocks, and each number compared beside its limit on standard
error, and one JSON object as the last line of standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read
from a torch.profiler trace of the window (``--trace 1``).  Exits with a
nonzero code and prints no result when no card is visible, when the
program cannot be imported, or when a forbidden module is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Where the program looks up tuned knobs: a fixed directory of the
# checkout that nothing writes, so every run takes the built-in defaults.
TUNE_CACHE = HERE / "tune_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    TUNE_CACHE.mkdir(exist_ok=True)
    if any(TUNE_CACHE.iterdir()):
        print(f"[portbench] {TUNE_CACHE} must be empty", file=sys.stderr)
        return 2
    os.environ["REPRO_TUNE_CACHE"] = str(TUNE_CACHE)
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from portbench import harness
    try:
        cell = harness.load_cell(args.workload)
    except harness.HarnessError as exc:
        print(f"[portbench] {exc}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("[portbench] no CUDA card is visible: the benchmark runs "
              "only on the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    print(f"[portbench] card: {harness.device_line()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.HarnessError as exc:
        print(f"[portbench] {exc}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
