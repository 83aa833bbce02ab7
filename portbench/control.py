"""Readings that set a cell's limits, on the card: the program's own runs
over many seeds (the lower reading) and the control, the program's
float32 path put in the float64 path's place (the upper reading), each a
short window at the cell's load judged as a benchmark run judges it.

    python3 portbench/control.py --workload glued.batch128 \
        --seeds 1,2,3 --seconds 2

One process reads every seed of both sides.  Prints one JSON line a seed
and side, then a summary line.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell, seed: int, seconds: float, knobs) -> dict:
    """One short run of ``cell`` on the card, as the benchmark runs it,
    with ``knobs`` passed to the entry point: its checks' readings."""
    from portbench import harness
    res = harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                           knobs=knobs, log=lambda msg: None)
    return {name: c["value"] for name, c in res["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sides", default="program,control")
    args = ap.parse_args(argv)
    os.environ["REPRO_TUNE_CACHE"] = str(HERE / "tune_cache")
    (HERE / "tune_cache").mkdir(exist_ok=True)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    sides = {"program": {}, "control": {"dtype": torch.float32}}
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            r = readings(cell, seed, args.seconds, sides[side])
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": side, **r}), flush=True)
            w = worst.setdefault(side, {"err_eps": [], "missed": []})
            w["err_eps"].append(r["err_eps"])
            w["missed"].append(r["missed"])
    summary = {side: {"err_eps_max": max(w["err_eps"]),
                      "err_eps_min": min(w["err_eps"]),
                      "missed_max": max(w["missed"]),
                      "missed_min": min(w["missed"])}
               for side, w in worst.items()}
    print(json.dumps({"workload": cell.name, "summary": summary,
                      "card": harness.device_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
