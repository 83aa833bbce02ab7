#!/usr/bin/env python3
"""Where the time of ``precision="mixed"`` goes on a glued-Wilkinson batch
(needs a CUDA card).

    python3 scripts/profile_glued_mixed.py [--batch 64] [--n 4096]

The glued-Wilkinson batch is the case where the mixed pipeline's refine
rounds leave lanes uncertified and the request ladder re-solves whole
problems natively (ROADMAP Queue 3 item 3).  After one warm-up solve of a
uniform batch of the same shape (plans and kernels built), it runs
``eigvalsh_tridiagonal(D, E, precision="mixed")`` on the glued batch once
under cProfile and prints:

  * the wall time and the refinement / degradation counters;
  * the host split: cumulative time of the refine rounds, of the
    count + derivative sweeps inside them, and of the ladder's native
    re-solves (one problem at a time);
  * for comparison, the wall time of one native solve of the batch's
    first problem and of one native solve of the whole batch.

(torch.profiler is not used: the ladder's re-solves launch millions of
small kernels, and summarising their trace takes longer than the run.)
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_glued_mixed: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    from repro_torch.core import (SOLVE_COUNTER, eigvalsh_tridiagonal,
                                  make_family_batch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    B, n = args.batch, args.n
    Du, Eu = make_family_batch("uniform", n, B, seed0=100)
    Dg, Eg = make_family_batch("glued_wilkinson", n, B, seed0=100)
    eigvalsh_tridiagonal(Du, Eu, precision="mixed")
    torch.cuda.synchronize()

    host = cProfile.Profile()
    with SOLVE_COUNTER.measure(refinement=True) as win:
        t0 = time.perf_counter()
        host.enable()
        lam = eigvalsh_tridiagonal(Dg, Eg, precision="mixed")
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t0
    if not bool(torch.isfinite(lam).all()) or lam.shape != (B, n):
        raise AssertionError(f"bad output {tuple(lam.shape)}")
    print(f"[glued mixed] B={B} n={n} f64 ({smi}): wall {wall:.2f} s "
          f"(under cProfile); refinement {win.refinement_stats}; degradation "
          f"{win.degradation_stats}")

    stats = pstats.Stats(host)
    wanted = {"refine_clusters": "refine rounds",
              "_refine_executor": "refine trips",
              "count_and_newton_batched": "count + derivative sweeps",
              "_resolve_native_rows": "ladder native re-solves",
              "_solve_direct_single": "one native re-solve"}
    for (path, _, func), (_, ncalls, _, cum, _) in stats.stats.items():
        if func in wanted and "repro_torch" in path:
            print(f"[glued mixed] host {wanted[func]} ({func}): {ncalls} "
                  f"calls, {cum:.2f} s cumulative")

    for label, fn in (("one problem", lambda: eigvalsh_tridiagonal(
            Dg[0], Eg[0])), (f"the batch of {B}", lambda:
                             eigvalsh_tridiagonal(Dg, Eg))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"[glued mixed] native solve of {label}: "
              f"{time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
