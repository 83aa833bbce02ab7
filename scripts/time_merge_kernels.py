#!/usr/bin/env python3
"""Time the port's hand-written kernels on one CUDA card, at the shapes of
the kernel table in PERF.md and at the levels of the solves they serve.

    python3 scripts/time_merge_kernels.py [--kernels merge|two_pass|postpass|
                                                     sturm|chain]
                                          [--src DIR] [--label NAME]
                                          [--sweep-clusters] [--sweep]

``--src`` imports ``repro_torch`` from another checkout's ``src`` (for
instance an unpacked parent commit: ``git archive <commit> src | tar -x
-C build/parent``), so two versions of the kernels can be timed in turns
inside one call on one card (parent, change, change, parent); each builds
its own kernels under its own checkout.  Inputs are made from fixed seeds
with numpy: sorted N(0, 1) poles, unit-norm weights, rho = 0.7, kprime as
given (the level shapes use kprime = K, no deflation: the most work a
level can take).  Times are CUDA events, median of 5 after a warm-up.
Every line printed is one JSON object with the card's name and power
limit.

``--kernels merge`` (the default): the main path's two merge kernels --
the secular root solve (``csrc/secular_roots.cu``) and the resident merge
(``csrc/resident_merge.cu``) -- at every level of an n = 16384 solve that
each serves, with the real lane counts.  The bound is the larger of the
operations over 34 TFLOP/s (FP64, a division or reciprocal counting as
one) and the bytes over 3.35 TB/s, as in chip_smoke.py.  For the root
solve the FP64 instruction rate is estimated too: the FP64-pipe
instructions of one term of the g/g' sweep, read from the kernel's SASS
(cuobjdump), times the terms it sweeps, over the time; its share is
against 64 FP64 lanes per SM per clock at the card's maximum SM clock
(None where the toolkit has no cuobjdump).
(The resident merge has other loops with a reciprocal per term -- the
columns -- so the same reading would not isolate its sweep; it gets
none.)  ``--sweep-clusters`` times the resident shapes once more at every
cluster size C the kernel takes (a power of two up to 16 and K / 32),
with one CTA per team of a C-th of the lane, in place of the size that
``launch_shape`` picks, and says whether the results equal the picked
launch's bit for bit.

``--kernels two_pass``: the two-pass row update
(``csrc/boundary_update.cu``) and the QL kernel (``csrc/sterf.cu``):

  * the row update at chip_smoke.py's phase-2 shapes (r = 3 at B = 4,
    K = 4096 and B = 2, K = 8192; r = K at K = 2048 and 4096; r = 5 at
    K = 4096; kprime = 7K/8), beside ``torch.matmul`` of a pre-formed Y
    (the product only);
  * the row update at two r = K levels that deflate all but 1/16 of the
    poles (B = 2, K = 8192, kprime = 512; B = 1, K = 16384,
    kprime = 1024): the top levels of a full-vector solve of a uniform
    matrix are mostly the copy of R's deflated columns;
  * the row update at every r = K level of an n = 8192 full-vector solve
    (8192 / K lanes, K = 64 ... 8192) and at every r = 3 level of an
    n = 16384 ``fused=False`` solve (16384 / K lanes, K = 64 ... 16384);
  * sterf at n = 1024 and 4096 (uniform, float64), and at n = 4096 once
    more with (d, e) in device memory throughout -- the regime of a
    problem too large for the block's shared memory (n > 14528 in
    float64) until its active rows fit -- where the version has that
    regime.

``--kernels postpass``: the weight kernel of the two-pass conquer
(``csrc/zhat.cu``) and the fused post-pass (``csrc/fused_update.cu``):

  * zhat at chip_smoke.py's shapes (B = 4, K = 4096 and B = 2, K = 8192,
    kprime = 7K/8; B = 1, K = 16384, kprime = 14336), at the post-pass
    table's (B = 8, K = 2048, kprime = 1536: the post-pass's pass A is
    the same kernel) and at every level of an n = 16384 lazy or
    full-vector solve (16384 / K lanes, K = 64 ... 16384, kprime = K);
  * the post-pass at the kernel table's shape (B = 8, r = 3, K = 2048,
    kprime = 1536) and at the levels an n = 16384 solve gives it (r = 2:
    4 lanes at K = 4096, 2 at K = 8192; kprime = K).

Origin and tau come from the version's own root solve.  Each line has
the median time of one call (``ms``, as the other modes and
chip_smoke.py time a kernel) and of one call in a burst of 20 back to
back (``ms_in_burst_of_20``: the device's time, the wrapper's host time
hidden); the function's bound, the table's (operations over 34 TFLOP/s
-- zhat 5 per (pole, root) pair, the post-pass 10 + 2r -- or bytes over
3.35 TB/s); and two diagnostics of the code as compiled: the FP64-pipe
instructions and all instructions per pair of the version's hot loop
(``scripts/sass.py``: SASS read with cuobjdump) times the pairs, over
the card's SMs x 64 FP64 lanes (``fp64_instr_bound_ms``) and x 128
issue slots (``issue_slot_ms``) an SM per clock, at the SM clock
measured in this call (the Sturm chain probe's clock64 cycles over its
time); None where the toolkit has no cuobjdump.

``--kernels sturm``: the Sturm-count kernels (``csrc/sturm_count.cu``):

  * the count and the count + derivative (Newton) sweeps at the certify
    shape (B = 64, n = 4096, S = 8192 sorted shifts across the spectrum,
    the uniform batch of chip_smoke.py), at a bisection trip's (B = 1,
    n = 16384, S = 64), at the certify sweep of n = 16384 (B = 1,
    S = 32768) and at B = 64, n = 4096 with S = 512, 1024 and 2048
    (mid-sized refine and certify sweeps), each with its bound
    (operations over 34 TFLOP/s or bytes over 3.35 TB/s, as in
    chip_smoke.py) and the Newton layout the version picks, and, at the
    certify shape, the FP64-pipe and all instructions a row of the
    version's hot loop (``scripts/sass.py``) as FP64-pipe bound and
    issue-slot time;
  * the bisection tree, where the version has one: one launch from the
    Gershgorin brackets at the range solve's shape (B = 1, n = 16384,
    bottom k = 64, depth 8), the edges probes' (B = 128, n = 4096 -- the
    uniform batch twice --, k = 8) and ``method="bisect"``'s (B = 1,
    n = 4096, k = 4096), at the depths ``tune.bisect_depth`` gives
    (``--sweep``: at every depth 1-8, with the time per halving; and the
    Newton sweep with two threads a shift and with one at each of the
    shapes above and at B = 64, n = 4096 with S = 16 ... 4096 shifts a
    problem);
  * the chain probe (one shift's chain on one thread, n = 16384): the
    latency bound of a trip, beside which each trip and tree launch is
    printed as a ratio (scaled to its n).

``--kernels chain``: the deflation chain (``csrc/deflate_chain.cu``) on
real merge lanes, each level's chain inputs recorded by a spy on
``merge._deflate_level`` during a card solve:

  * the kernel table's r = 3 shapes, as chip_smoke.py makes them: the
    K = 2048 level of a glued-Wilkinson B = 32 x 4000 batch (W = 64,
    ``return_boundary=True``) and the K = 16384 level of a uniform
    n = 16000 solve (W = 1);
  * the r = K levels of the glued-Wilkinson n = 4096 lazy solve (the
    first problem of ``time_solves.py``'s batch, R as the solve gives
    it): K = 512 (W = 8), 2048 (W = 2) and 4096 (W = 1);

each with the route the version takes, one call's median time and the
median of a burst of 20 (as ``postpass``), the dependent steps of the
longest lane, the chain bound (those steps times the chain probe's
window step, timed in this call), the bytes bound (d, z, the masks and
all of R read once and written once over 3.35 TB/s) and the bound of R's
touched entries alone (the rotated columns read and written once); and,
for a version with the split route, each kernel's device time in one
traced call (torch.profiler).
``--sweep`` (a version with the split route) also times both routes at
r = 1 ... 128 rows of random R on each of those lanes' (d, z) and the
split route at every segment count 1 ... 64 at r = K and r = 128,
checking that every forced shape gives the default launch's bits: the
measurement behind ``SPLIT_MIN_R`` and ``APPLY_TARGET``.

The row update's origin and tau come from the version's own root solve
and its weights from its own zhat kernel.  Its bound is the larger of its
operations -- the product's 2 r kprime^2 per lane over the FP64 tensor
cores' 67 TFLOP/s, the other 5 kprime^2 (the y entries and norms) over
34 TFLOP/s -- and its bytes over 3.35 TB/s, as in chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import sass

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_FP64 = 34e12
PEAK_FP64_TENSOR = 67e12
PEAK_BYTES = 3.35e12

# (B, K, kprime) of the root solve: the table's shape, then the levels
# above the resident threshold of an n = 16384 solve (4, 2 and 1 lanes;
# the top merge runs the root solve alone).
ROOTS = [(1, 16384, 16384), (4, 4096, 4096), (2, 8192, 8192)]
# (B, r, K, kprime) of the resident merge: the table's shape, the
# resident levels of an n = 16384 solve (r = 2, the boundary rows), and
# the largest level of the B = 64 x 4096 batch (128 lanes).
RESIDENT = [(64, 3, 2048, 1536), (256, 2, 64, 64), (128, 2, 128, 128),
            (64, 2, 256, 256), (32, 2, 512, 512), (16, 2, 1024, 1024),
            (8, 2, 2048, 2048), (128, 2, 2048, 2048)]
# (B, r, K, kprime) of the row update: chip_smoke.py's phase-2 shapes.
PHASE2 = [(4, 3, 4096, 3584), (2, 3, 8192, 7168), (1, 5, 4096, 3584),
          (1, 2048, 2048, 1792), (1, 4096, 4096, 3584)]
# The top r = K levels of a full-vector solve of a matrix that deflates
# nearly every pole (as the uniform family does): mostly the pass-through
# of R's deflated columns.
DEFLATED = [(2, 8192, 8192, 512), (1, 16384, 16384, 1024)]
FULL_N = 8192
FUSED_FALSE_N = 16384
STERF_N = (1024, 4096)


def _secular_ops(B, kp, niter):
    """Operations per (root, pole) pair of the root solve, as chip_smoke's
    _secular_ops: 18 + 6 per iteration."""
    return float(B) * kp * kp * (18 + 6 * niter)


def _postpass_ops(B, kp, r):
    return float(B) * kp * kp * (10 + 2 * r)


def _levels(n, rows):
    """(B, r, K, kprime) of every level of an n-point solve from K = 64:
    n / K lanes of K roots, r rows each (r = K where rows is None)."""
    out, K = [], 64
    while K <= n:
        out.append((n // K, K if rows is None else rows, K, K))
        K *= 2
    return out


def _row_update_bound_ms(B, r, kp, K):
    pairs = float(B) * kp * kp
    fma, rest = pairs * 2 * r, pairs * 5
    t_ops = fma / PEAK_FP64_TENSOR + rest / PEAK_FP64
    t_bytes = ((2 * r + 3) * 8 + 4) * B * K / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3


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
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def burst_ms(fn, launches=20, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``launches`` calls
    of fn() back to back, over ``launches``: the device's time per call
    once the host's wrapper time (tens of microseconds a call) overlaps
    the kernels before it."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def problem(dev, B, K, kp, rng):
    """A float64 merge problem on ``dev`` drawn from ``rng``: d, z, rho,
    kprime."""
    import numpy as np
    import torch
    d = np.sort(rng.standard_normal((B, K)), axis=1)
    d[:, kp:] += 10.0
    z = rng.standard_normal((B, K))
    z[:, kp:] = 0.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return (t(d), t(z), torch.full((B,), 0.7, dtype=torch.float64,
                                   device=dev),
            torch.full((B,), kp, dtype=torch.int32, device=dev))


def _instructions_per_item(build, name, kernel, per_item=1):
    """(FP64-pipe instructions, all instructions) per item of ``kernel``'s
    hot loop in the version's built lib<name>.so (scripts/sass.py), or
    None where the toolkit has no cuobjdump."""
    return sass.instructions_per_item(build.build_dir() / f"lib{name}.so",
                                      kernel, per_item)


def _sm_clock_hz(dev):
    """The SM clock in this call: the Sturm chain probe's clock64 cycles
    over its CUDA-event time (one thread walking 16384 rows)."""
    import numpy as np
    import torch
    from repro_torch.kernels.sturm_count import chain_probe_cuda
    rng = np.random.default_rng(0)
    d = torch.tensor(rng.standard_normal(16384), device=dev)
    e2 = torch.tensor(rng.standard_normal(16383) ** 2, device=dev)
    _, cycles = chain_probe_cuda(d, e2, 0.0, 1e-300)
    return int(cycles) / (median_ms(
        lambda: chain_probe_cuda(d, e2, 0.0, 1e-300)) * 1e-3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--kernels", choices=("merge", "two_pass", "postpass",
                                          "sturm", "chain"), default="merge")
    ap.add_argument("--src", default=os.path.join(HERE, "..", "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--sweep-clusters", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_merge_kernels: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    dev = torch.device("cuda", 0)
    smi = card()
    if args.kernels == "two_pass":
        return _time_two_pass(args.label, dev, smi)
    if args.kernels == "postpass":
        return _time_postpass(args.label, dev, smi)
    if args.kernels == "sturm":
        return _time_sturm(args.label, dev, smi, args.sweep)
    if args.kernels == "chain":
        return _time_chain(args.label, dev, smi, args.sweep)
    return _time_merge(args, dev, smi)


def _time_merge(args, dev, smi):
    import numpy as np
    import torch
    from repro_torch.kernels import resident_merge as rmod
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda

    # FP64 instruction rate of the root solve: the sweeps with a
    # reciprocal (niter + 4 of the niter + 5) issue per_term FP64-pipe
    # instructions per (root, pole) pair; over the card's FP64 issue rate,
    # 64 lanes per SM per clock.
    from repro_torch.kernels import _build
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    peak_instr = (torch.cuda.get_device_properties(0).multi_processor_count
                  * 64 * float(clock[0]) * 1e6) if clock else None
    _build.build_all(["secular_roots"])
    counts = _instructions_per_item(_build, "secular_roots",
                                    "secular_roots_kernelIdE")
    per_term = {"secular_roots": counts and counts[0], "resident_merge": None}

    def emit(kernel, shape, ms, ops, nbytes, pairs, **extra):
        bound = max(ops / PEAK_FP64, nbytes / PEAK_BYTES) * 1e3
        rate = (per_term[kernel] * pairs * (niter + 4) / (ms * 1e-3)
                if per_term[kernel] else None)
        print(json.dumps(dict(
            label=args.label, kernel=kernel, shape=shape, ms=ms,
            bound_ms=bound, ops_per_s=ops / (ms * 1e-3),
            fp64_per_term=per_term[kernel], fp64_instr_per_s=rate,
            fp64_issue_share=(rate / peak_instr if rate and peak_instr
                              else None), card=smi, **extra)), flush=True)

    niter = 16
    for B, K, kp in ROOTS:
        d, z, rho, kpr = problem(dev, B, K, kp,
                                 np.random.default_rng(K + kp))
        z2 = z * z
        ms = median_ms(lambda: secular_solve_cuda(d, z2, rho, kpr,
                                                  niter=niter))
        emit("secular_roots", f"B={B} K={K} kprime={kp} f64", ms,
             _secular_ops(B, kp, niter), (2 * 8 + 4 + 8) * B * K + 12 * B,
             float(B) * kp * kp)
    torch.manual_seed(0)
    for B, r, K, kp in RESIDENT:
        d, z, rho, kpr = problem(dev, B, K, kp, np.random.default_rng(K + r))
        R = torch.randn(B, r, K, dtype=torch.float64, device=dev)
        ms = median_ms(lambda: resident_merge_cuda(d, z, R, rho, kpr,
                                                   niter=niter))
        extra = {}
        if hasattr(rmod, "launch_shape"):
            s = rmod.launch_shape(B, K, r, torch.float64, rmod.sm_count(0))
            extra = dict(team=s.team, cluster=s.cluster, threads=s.threads,
                         smem=s.smem, max_active_clusters=(
                             rmod.max_active_clusters(0, torch.float64, r, K,
                                                      s)))
        emit("resident_merge", f"B={B} r={r} K={K} kprime={kp} f64", ms,
             _secular_ops(B, kp, niter) + _postpass_ops(B, kp, r),
             ((2 * r + 6) * 8 + 4) * B * K + 12 * B, float(B) * kp * kp,
             **extra)
        if args.sweep_clusters:
            _sweep_clusters(rmod, emit, d, z, R, rho, kpr, B, r, K, kp,
                            niter)
    return 0


def _sweep_clusters(rmod, emit, d, z, R, rho, kpr, B, r, K, kp, niter):
    """The resident merge at every cluster size it takes, launched through
    its wrapper with launch_shape replaced for the call."""
    import torch
    picked = rmod.launch_shape
    ref = rmod.resident_merge_cuda(d, z, R, rho, kpr, niter=niter)
    C = 1
    try:
        while C <= min(rmod.MAX_CLUSTER, max(1, K // rmod.MIN_ROOTS_PER_CTA)):
            share = -(-K // C)
            shape = rmod.LaunchShape(
                rmod.TEAM, C,
                min(rmod.MAX_THREADS, -(-share * rmod.TEAM // 32) * 32),
                rmod.smem_bytes(r, K, torch.float64))
            rmod.launch_shape = lambda *a, s=shape: s
            out = rmod.resident_merge_cuda(d, z, R, rho, kpr, niter=niter)
            ms = median_ms(lambda: rmod.resident_merge_cuda(
                d, z, R, rho, kpr, niter=niter))
            emit("resident_merge", f"B={B} r={r} K={K} kprime={kp} f64", ms,
                 _secular_ops(B, kp, niter) + _postpass_ops(B, kp, r),
                 ((2 * r + 6) * 8 + 4) * B * K + 12 * B, float(B) * kp * kp,
                 sweep=True, cluster=C, threads=shape.threads,
                 max_active_clusters=rmod.max_active_clusters(
                     0, torch.float64, r, K, shape),
                 bitwise_equal=all(torch.equal(a, b)
                                   for a, b in zip(out, ref)))
            C *= 2
    finally:
        rmod.launch_shape = picked


# (B, K, kprime) of zhat: chip_smoke.py's shapes and the post-pass
# table's (zhat is the post-pass's pass A), then every level of an
# n = 16384 lazy or full-vector solve.
ZHAT = ([(4, 4096, 3584), (2, 8192, 7168), (1, 16384, 14336),
         (8, 2048, 1536)]
        + [(16384 // K, K, K) for K in (64, 128, 256, 512, 1024, 2048, 4096,
                                        8192, 16384)])
# (B, r, K, kprime) of the post-pass: the kernel table's shape, then the
# levels an n = 16384 solve gives it (r = 2, the boundary rows).
POSTPASS = [(8, 3, 2048, 1536), (4, 2, 4096, 4096), (2, 2, 8192, 8192)]


def _time_postpass(label, dev, smi):
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.zhat import zhat_reconstruct_cuda
    _build.build_all(["zhat", "fused_update", "sturm_count",
                      "secular_roots"])
    clock = _sm_clock_hz(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pair = {
        "zhat": _instructions_per_item(_build, "zhat", "weights_kernelIdE"),
        "pass A": _instructions_per_item(_build, "fused_update",
                                         "weights_kernelIdE"),
        "pass B": _instructions_per_item(_build, "fused_update",
                                         "rows_kernelIdE")}

    def emit(kernel, shape, run, ops, nbytes, pairs, instr):
        table = max(ops / PEAK_FP64, nbytes / PEAK_BYTES) * 1e3
        fp64, issue = ((instr[0] * pairs / (sms * 64 * clock) * 1e3,
                        instr[1] * pairs / (sms * 128 * clock) * 1e3)
                       if instr else (None, None))
        print(json.dumps(dict(
            label=label, kernel=kernel, shape=shape, ms=median_ms(run),
            ms_in_burst_of_20=burst_ms(run), bound_ms=table,
            fp64_per_pair=instr and instr[0],
            instructions_per_pair=instr and instr[1],
            sm_clock_mhz=clock / 1e6, fp64_instr_bound_ms=fp64,
            issue_slot_ms=issue, card=smi)), flush=True)

    for B, K, kp in ZHAT:
        d, z, rho, kpr = problem(dev, B, K, kp,
                                 np.random.default_rng(K + kp))
        o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=16)
        emit("zhat", f"B={B} K={K} kprime={kp} f64",
             lambda: zhat_reconstruct_cuda(d, z, o, t, kpr, rho),
             float(B) * kp * kp * 5, (4 * 8 + 4) * B * K + 12 * B,
             float(B) * kp * kp, per_pair["zhat"])
        del d, z, o, t
    torch.manual_seed(0)
    for B, r, K, kp in POSTPASS:
        d, z, rho, kpr = problem(dev, B, K, kp, np.random.default_rng(K + r))
        o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=16)
        R = torch.randn(B, r, K, dtype=torch.float64, device=dev)
        pa, pb = per_pair["pass A"], per_pair["pass B"]
        ab = (pa[0] + pb[0], pa[1] + pb[1]) if pa and pb else None
        emit("fused_update", f"B={B} r={r} K={K} kprime={kp} f64",
             lambda: secular_postpass_cuda(R, d, z, o, t, kpr, rho),
             _postpass_ops(B, kp, r), ((2 * r + 4) * 8 + 4) * B * K + 12 * B,
             float(B) * kp * kp, ab)
    return 0


def _time_two_pass(label, dev, smi):
    import numpy as np
    import torch
    from repro_torch.core import make_family
    from repro_torch.kernels import sterf as qlk
    from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.zhat import zhat_reconstruct_cuda
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(**rec):
        print(json.dumps(dict(label=label, card=smi, **rec)), flush=True)

    def inputs(B, r, K, kp, seed):
        rng = np.random.default_rng(seed)
        d, z, rho, kpr = problem(dev, B, K, kp, rng)
        o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=16)
        w = zhat_reconstruct_cuda(d, z, o, t, kpr, rho)
        R = torch.tensor(rng.standard_normal((B, r, K)), device=dev)
        return R, d, w, o, t, kpr

    def dense_y(d, w, o, t, kpr):
        B, K = d.shape
        d_org = torch.gather(d, 1, o.long())
        active = torch.arange(K, device=dev)[None, :] < kpr[:, None]
        delta = (d[:, :, None] - d_org[:, None, :]) - t[:, None, :]
        act_i = active[:, :, None]
        Y = torch.where(act_i, w[:, :, None] / torch.where(
            act_i & (delta != 0), delta, torch.ones_like(delta)),
            torch.zeros_like(delta))
        del delta
        Y /= (Y * Y).sum(1).sqrt().clamp(min=1e-300)[:, None, :]
        return torch.where(active[:, None, :], Y,
                           torch.eye(K, dtype=d.dtype, device=dev))

    for group, shapes in (("phase2", PHASE2), ("deflated", DEFLATED),
                          (f"full n={FULL_N}", _levels(FULL_N, None)),
                          (f"fused=False n={FUSED_FALSE_N}",
                           _levels(FUSED_FALSE_N, 3))):
        for B, r, K, kp in shapes:
            R, d, w, o, t, kpr = inputs(B, r, K, kp, seed=K + r + 7)
            ms = median_ms(lambda: boundary_rows_update_cuda(
                R, d, w, o, t, kpr))
            lib = None
            if group == "phase2":
                Y = dense_y(d, w, o, t, kpr)
                lib = median_ms(lambda: torch.matmul(R, Y))
                del Y
            emit(kernel="boundary_update", group=group,
                 shape=f"B={B} r={r} K={K} kprime={kp} f64", ms=ms,
                 bound_ms=_row_update_bound_ms(B, r, kp, K), matmul_ms=lib,
                 product_tflops=2.0 * B * r * kp * kp / (ms * 1e-3) / 1e12)
            del R, d, w, o, t, kpr
            torch.cuda.empty_cache()

    # sterf, and at the largest n the device-memory regime (rows = 0) of
    # a version whose kernel has one (launch_shape gives its rows).
    for n in STERF_N:
        d, e = make_family("uniform", n, seed=0)
        dd = torch.tensor(d, device=dev)[None]
        ee = torch.tensor(e, device=dev)[None]
        runs = [("launch_shape", lambda: qlk.sterf_cuda(dd, ee))]
        if n == max(STERF_N) and hasattr(qlk, "launch_shape"):
            runs.append(("device memory", lambda: qlk._launch(
                dd, ee, 30 * n, 0)[1:]))
        for regime, run in runs:
            rot = int(run()[-1][0])
            ms = median_ms(run)
            emit(kernel="sterf", shape=f"B=1 n={n} uniform f64",
                 regime=regime, ms=ms, rotations=rot,
                 ns_per_rotation=ms * 1e6 / rot)
    return 0


def _sturm_hot_loop(build, newton):
    """(FP64-pipe, all) instructions a row of the certify sweep's hot loop:
    this version's count kernel (one shift a thread), or the parent's
    ``sturm_kernel``."""
    for kernel in (f"count_kernelIdLb{int(newton)}EE",
                   f"sturm_kernelIdLb{int(newton)}EE"):
        got = _instructions_per_item(build, "sturm_count", kernel,
                                     2 if newton else 1)
        if got:
            return got
    return None


def _newton_ms_by_layout(sc, d, e2, x, piv):
    """Times of one count + derivative sweep with two threads a shift
    ("split") and one ("one"), through the wrapper's private launch."""
    return {("split" if split else "one"): median_ms(
        lambda split=split: sc._launch(
            sc.sturm_count_newton_cuda, "sturm_count_newton", True, d, e2,
            x, piv, split=split))
        for split in (True, False)}


def _time_sturm(label, dev, smi, sweep=False):
    import numpy as np
    import torch
    from repro_torch.core import bisect as bis
    from repro_torch.core import make_family, make_family_batch, tune
    from repro_torch.kernels import _build
    from repro_torch.kernels import sturm_count as sc
    _build.build_all(["sturm_count"])
    clock = _sm_clock_hz(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def emit(**rec):
        print(json.dumps(dict(label=label, card=smi, **rec)), flush=True)

    d16, e16 = make_family("uniform", 16384, seed=0)
    Du, Eu = make_family_batch("uniform", 4096, 64, seed0=100)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    d64, e64 = t(d16), t(e16) ** 2
    piv64 = float(bis._pivot_floor(e64[None])[0, 0])
    chain_ms = median_ms(lambda: sc.chain_probe_cuda(d64, e64, 0.0, piv64))
    emit(kernel="chain_probe", shape="n=16384 f64", ms=chain_ms,
         ns_per_row=chain_ms * 1e6 / 16384)

    # The certify shape, a trip's, the certify sweep at n = 16384 (2n
    # shifts of one problem) and mid-sized sweeps of the batch (refine
    # sweeps, certify of a partial spectrum): the last two span the
    # crossover from one shift a thread to two.
    for B, D, E, S in ((64, Du, Eu, 8192), (1, d16[None], e16[None], 64),
                       (1, d16[None], e16[None], 32768), (64, Du, Eu, 512),
                       (64, Du, Eu, 1024), (64, Du, Eu, 2048)):
        d, e2 = t(D), t(E) ** 2
        n = d.shape[1]
        piv = bis._pivot_floor(e2)
        lo, hi = float(d.min()) - 2.5, float(d.max()) + 2.5
        x = torch.sort(lo + (hi - lo) * torch.rand(
            B, S, dtype=torch.float64, device=dev,
            generator=torch.Generator(device=dev).manual_seed(S)),
            dim=1).values
        for newton in (False, True):
            fn = sc.sturm_count_newton_cuda if newton else sc.sturm_count_cuda
            ms = median_ms(lambda: fn(d, e2, x, piv[:, 0]))
            ops = float(B) * S * n * (7 if newton else 3)
            nbytes = (B * (2 * n + S) * 8 + B * S * 4
                      + (B * S * 8 if newton else 0))
            rec = dict(kernel="sturm_count_newton" if newton
                       else "sturm_count", shape=f"B={B} n={n} S={S} f64",
                       ms=ms, bound_ms=max(ops / PEAK_FP64,
                                           nbytes / PEAK_BYTES) * 1e3,
                       chain_ratio=ms / (chain_ms * n / 16384))
            if newton and hasattr(sc, "launch_shape"):
                rec["split"] = sc.launch_shape(B, S, sms, newton=True)[0]
            if newton and sweep:
                rec["ms_by_layout"] = _newton_ms_by_layout(sc, d, e2, x,
                                                           piv[:, 0])
            if B > 1 and S == 8192:
                instr = _sturm_hot_loop(_build, newton)
                rows = float(B) * S * n
                rec.update(
                    fp64_per_row=instr and instr[0],
                    instructions_per_row=instr and instr[1],
                    fp64_instr_bound_ms=instr and (
                        instr[0] * rows / (sms * 64 * clock) * 1e3),
                    issue_slot_ms=instr and (
                        instr[1] * rows / (sms * 128 * clock) * 1e3))
            emit(**rec)

    if sweep:
        # Where the Newton sweep's two threads a shift give way to one, at
        # B = 64 x 4096 and S shifts a problem, from a trip's few towards
        # the certify sweep's 8192.
        d, e2 = t(Du), t(Eu) ** 2
        piv = bis._pivot_floor(e2)
        for S in (16, 64, 128, 256, 384, 768, 1536, 4096):
            x = torch.sort(-2.0 + 4.0 * torch.rand(
                64, S, dtype=torch.float64, device=dev,
                generator=torch.Generator(device=dev).manual_seed(S)),
                dim=1).values
            emit(kernel="sturm_count_newton", shape=f"B=64 n=4096 S={S} f64",
                 split=sc.launch_shape(64, S, sms, newton=True)[0],
                 ms_by_layout=_newton_ms_by_layout(sc, d, e2, x, piv[:, 0]))

    if not hasattr(sc, "sturm_bisect_tree_cuda"):
        return 0
    chains = tune.backend_defaults("cuda")["bisect_chains"]
    for case, D, E, tg in (
            ("range", d16[None], e16[None], np.arange(64)[None]),
            ("edges", np.concatenate([Du, Du]), np.concatenate([Eu, Eu]),
             np.concatenate([np.tile(np.arange(8), (64, 1)),
                             np.tile(np.arange(4088, 4096), (64, 1))])),
            ("bisect", Du[:1], Eu[:1], np.arange(4096)[None])):
        d, e = t(D), t(E)
        e2 = e * e
        piv = bis._pivot_floor(e2)
        glo, ghi = bis._gershgorin(d, e.abs(), piv)
        tol = (2.0 * torch.finfo(torch.float64).eps
               * torch.maximum(glo.abs(), ghi.abs()) + 2.0 * piv)
        targets = torch.tensor(tg, dtype=torch.int32, device=dev)
        B, k = targets.shape
        n = d.shape[1]
        depth = tune.bisect_depth(B * k, chains)
        lo = glo.expand(B, k).contiguous()
        hi = ghi.expand(B, k).contiguous()
        for m in (range(1, sc.MAX_DEPTH + 1) if sweep else (depth,)):
            ms = median_ms(lambda: sc.sturm_bisect_tree_cuda(
                d, e2, piv[:, 0], tol[:, 0], targets, lo, hi, depth=m,
                steps=m))
            emit(kernel="sturm_bisect_tree", case=case,
                 shape=f"B={B} n={n} k={k} depth={m} f64", ms=ms,
                 picked=m == depth, node_chains=B * k * (2 ** m - 1),
                 chain_ratio=ms / (chain_ms * n / 16384),
                 ms_per_halving=ms / m)
    return 0


def _chain_levels(fn):
    """{K: (d, z, R, small, tol)} of every level fn() sends through
    ``merge._deflate_level``."""
    from repro_torch.core import merge as mrg
    got = {}
    real = mrg._deflate_level

    def spy(d, z, R, small, tol, *, budget):
        got[d.shape[1]] = (d, z, R, small, tol)
        return real(d, z, R, small, tol, budget=budget)
    mrg._deflate_level = spy
    try:
        fn()
    finally:
        mrg._deflate_level = real
    return got


def _device_ms_by_kernel(fn):
    """{kernel name: device ms} of one traced call of fn() (torch.profiler;
    {} where the tracer records no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / 1e3
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def _time_chain(label, dev, smi, sweep=False):
    import torch
    sys.path.append(os.path.join(HERE, ".."))
    from chip_smoke import _window_steps
    from repro_torch.core import (eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_batch,
                                  eigvalsh_tridiagonal_br, make_family,
                                  make_family_batch)
    from repro_torch.kernels import deflate_chain as dck
    split = hasattr(dck, "launch_shape")

    def emit(**rec):
        print(json.dumps(dict(label=label, card=smi, **rec)), flush=True)

    D, E = make_family_batch("glued_wilkinson", 4000, 32, seed0=400)
    glued = _chain_levels(lambda: eigvalsh_tridiagonal_batch(
        D, E, return_boundary=True))[2048]
    d1, e1 = make_family("uniform", 16000, seed=16)
    uniform = _chain_levels(lambda: eigvalsh_tridiagonal_br(
        d1, e1, return_boundary=True))[16384]
    Dg, Eg = make_family_batch("glued_wilkinson", 4096, 64, seed0=100)
    lazy = _chain_levels(lambda: eigvalsh_tridiagonal(Dg[0], Eg[0],
                                                      method="lazy"))
    cases = [("glued W=64 r=3 K=2048", glued),
             ("uniform W=1 r=3 K=16384", uniform)] + [
        (f"glued lazy W={lazy[K][0].shape[0]} r=K={K}", lazy[K])
        for K in (512, 2048, 4096)]

    d_, z_, _, s_, t_ = glued
    reps = 65536
    probe = lambda: dck.chain_probe_cuda(  # noqa: E731
        d_[0], z_[0], s_[0], float(t_[0]), reps)
    step_ms = median_ms(probe) / reps
    emit(kernel="chain_probe", shape="glued W=64 K=2048 lane 0, f64",
         ns_per_step=step_ms * 1e6)

    for name, args in cases:
        W, r, K = args[2].shape
        run = lambda: dck.deflate_chain_cuda(*args)  # noqa: E731
        out = run()
        small = args[3].cpu().numpy()
        defl = out[3].cpu().numpy()
        steps = int(_window_steps(small, defl).max())
        touched = int(((out[2] != args[2]).any(dim=1)).sum(dim=1).max())
        item = args[0].element_size()
        nbytes = W * K * (4 * item + 2) + 2 * W * r * K * item + item * W
        rec = dict(kernel="deflate_chain", shape=f"{name} f64",
                   ms=median_ms(run), ms_in_burst_of_20=burst_ms(run),
                   steps=steps,
                   rotations=int((defl & ~small).sum(axis=1).max()),
                   chain_bound_ms=steps * step_ms,
                   bytes_bound_ms=nbytes / PEAK_BYTES * 1e3,
                   touched_bound_ms=2 * W * r * touched * item
                   / PEAK_BYTES * 1e3)
        if split:
            rec["shape_picked"] = dck.launch_shape(W, r, K,
                                                   args[0].dtype)._asdict()
            rec["device_ms_by_kernel"] = _device_ms_by_kernel(run)
        emit(**rec)
    if not (sweep and split):
        return 0

    # The route crossover and the segment count, on each case's (d, z).
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, (d, z, R0, small, tol) in cases:
        W, K = d.shape
        rows = [1, 2, 3, 4, 5, 8, 16, 32, 64, 128]
        if R0.shape[1] == K:
            rows.append(K)
        for r in rows:
            R = (R0 if r == K else torch.randn(
                (W, r, K), dtype=d.dtype, device=dev, generator=gen))
            args = (d, z, R, small, tol)
            want = dck.deflate_chain_cuda(*args)
            ms = {}
            shapes = {route: dck._shape(W, r, K, d.dtype, route)
                      for route in ("fused", "split")}
            if r in (128, K):
                for S in (1, 2, 4, 8, 16, 32, 64):
                    shapes[f"split S={S}"] = dck._shape(
                        W, r, K, d.dtype, "split", segments=S)
            for key, shape in shapes.items():
                got = dck._launch(*args, shape)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} r={r} {key}: other bits")
                ms[key] = median_ms(lambda: dck._launch(*args, shape))
            emit(kernel="deflate_chain", sweep=name, r=r,
                 picked=dck.launch_shape(W, r, K, d.dtype).route,
                 segments_picked=shapes["split"].apply_grid[2], ms=ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
