#!/usr/bin/env python3
"""Time the port's end-to-end solves on one CUDA card, and the share of
each solve that its merge levels' deflation chain, weights (zhat) and
fused post-pass take.

    python3 scripts/time_solves.py [--src DIR] [--label NAME] [--mixed]
                                   [--compare] [--sturm] [--reps N]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
instance an unpacked parent commit: ``git archive <commit> src | tar -x
-C build/parent``), so that two versions are timed in turns inside one
call on one card (parent, change, change, parent); each builds its own
kernels under its own checkout.

Solves, float64, inputs as ``chip_smoke.py`` makes them:
``eigvalsh_tridiagonal`` at n = 16384 (uniform, seed 0) and at n = 4096
(the first glued-Wilkinson problem of the batch), and
``eigvalsh_tridiagonal_batch`` at B = 64 x 4096 (uniform and glued
Wilkinson, seed0 100): CUDA events, median of 5 (``--reps``) after a
warm-up.  Then
one more run of each with ``merge._deflate_level``,
``ops.zhat_reconstruct_batched`` and ``ops.secular_postpass_batched``
each timed on the host clock between two ``torch.cuda.synchronize()``
calls: the deflation chain's time per level (the kernel's launch, or the
parent's Python chain with its host syncs) and the weights' and the
post-pass's time in all, beside the solve's wall time in that run.
``--compare`` adds the paper's comparison points that run zhat:
``fused=False``, ``method="lazy"`` and ``method="full"`` at n = 16384
(uniform) and n = 4096 (the glued-Wilkinson problem).
``--mixed`` also times one run of ``eigvalsh_tridiagonal`` of the
glued-Wilkinson B = 64 x 4096 batch with ``precision="mixed"``, whose
ladder re-solves every problem natively one at a time (minutes on a
version without the chain kernel).
``--sturm`` times the Sturm-count path in place of the solves above:
``eigvalsh_tridiagonal_range`` of the bottom 64 and of the band [8160,
8224) at n = 16384, ``kind="edges"`` (k = 8) on the uniform B = 64 x 4096
batch, ``method="bisect"`` at n = 4096 (its first problem), and
``certify=True`` and ``precision="mixed"`` at n = 16384; each with the
launches of each Sturm kernel one solve makes.
Every line printed is one JSON object with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event times of fn() after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--sturm", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_solves: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import (eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_batch, make_family,
                                  make_family_batch)
    from repro_torch.core import merge as mrg
    from repro_torch.kernels import ops

    smi = card()

    def emit(**kw):
        print(json.dumps(dict(kw, label=args.label, card=smi)), flush=True)

    d16, e16 = make_family("uniform", 16384, seed=0)
    Du, Eu = make_family_batch("uniform", 4096, 64, seed0=100)
    if args.sturm:
        return _time_sturm(emit, d16, e16, Du, Eu, args.reps)
    Dg, Eg = make_family_batch("glued_wilkinson", 4096, 64, seed0=100)
    solves = {
        "n=16384 uniform": lambda: eigvalsh_tridiagonal(d16, e16),
        "n=4096 glued_wilkinson": lambda: eigvalsh_tridiagonal(Dg[0], Eg[0]),
        "B=64 x 4096 uniform": lambda: eigvalsh_tridiagonal_batch(Du, Eu),
        "B=64 x 4096 glued_wilkinson": lambda: eigvalsh_tridiagonal_batch(
            Dg, Eg)}
    if args.compare:
        for label, (d, e) in (("n=16384 uniform", (d16, e16)),
                              ("n=4096 glued_wilkinson", (Dg[0], Eg[0]))):
            solves[f"{label} fused=False"] = (
                lambda d=d, e=e: eigvalsh_tridiagonal(d, e, fused=False))
            for method in ("lazy", "full"):
                solves[f"{label} {method}"] = (
                    lambda d=d, e=e, m=method: eigvalsh_tridiagonal(
                        d, e, method=m))

    def timed(real, log, K_of):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            log.append((K_of(*a), (time.perf_counter() - t0) * 1e3))
            return out
        return run

    for name, fn in solves.items():
        ms = median_ms(fn, args.reps)
        spied = {(mrg, "_deflate_level"): [],
                 (ops, "zhat_reconstruct_batched"): [],
                 (ops, "secular_postpass_batched"): []}
        reals = {key: getattr(*key) for key in spied}
        for (mod, attr), log in spied.items():
            setattr(mod, attr, timed(
                reals[mod, attr], log,
                (lambda R, d, *a: d.shape[1]) if attr.startswith("secular")
                else (lambda d, *a: d.shape[1])))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            for (mod, attr), real in reals.items():
                setattr(mod, attr, real)
        levels, zhat, post = spied.values()
        emit(solve=name, ms=ms, timed_run_wall_ms=wall,
             chain_ms=sum(t for _, t in levels),
             chain_ms_per_level={str(K): t for K, t in levels},
             zhat_ms=sum(t for _, t in zhat), zhat_launches=len(zhat),
             postpass_ms=sum(t for _, t in post),
             postpass_launches=len(post))
    if args.mixed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eigvalsh_tridiagonal(Dg, Eg, precision="mixed")
        torch.cuda.synchronize()
        emit(solve="B=64 x 4096 glued_wilkinson precision=mixed (one run)",
             ms=(time.perf_counter() - t0) * 1e3)
    return 0


def _time_sturm(emit, d16, e16, Du, Eu, reps):
    from repro_torch.core import (SolveRequest, eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_range, execute_request)
    from repro_torch.kernels import sturm_count as sc
    kernels = [getattr(sc, name) for name in (
        "sturm_count_cuda", "sturm_count_newton_cuda",
        "sturm_bisect_tree_cuda") if hasattr(sc, name)]
    solves = {
        "range bottom 64, n=16384": lambda: eigvalsh_tridiagonal_range(
            d16, e16, il=0, iu=63),
        "range band [8160, 8224), n=16384": lambda: (
            eigvalsh_tridiagonal_range(d16, e16, il=8160, iu=8223)),
        "edges k=8, B=64 x 4096": lambda: execute_request(SolveRequest(
            d=Du, e=Eu, kind="edges", knobs={"k": 8})),
        "bisect, n=4096": lambda: eigvalsh_tridiagonal(Du[0], Eu[0],
                                                       method="bisect"),
        "certify, n=16384": lambda: eigvalsh_tridiagonal(d16, e16,
                                                         certify=True),
        "mixed, n=16384": lambda: eigvalsh_tridiagonal(d16, e16,
                                                       precision="mixed")}
    for name, fn in solves.items():
        ms = median_ms(fn, reps)
        before = [k.launches for k in kernels]
        fn()
        emit(solve=name, ms=ms, launches={
            k.__name__: k.launches - b for k, b in zip(kernels, before)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
