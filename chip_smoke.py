#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the four CUDA sources from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel), then:

  1. prints the card (``nvidia-smi`` name and power limit), the CUDA
     version and the build time;
  2. holds each kernel against its plain torch version on the card at the
     main path's shapes, in float64 and float32 (tolerances of
     tests/test_kernels.py, float32 scaled by eps; the Sturm counts and
     their derivative sums bit for bit), timing both; times one shift's
     Sturm chain on one thread (the latency bound of a bisection trip);
  3. drives the main path -- ``eigvalsh_tridiagonal`` at n = 16384
     (uniform) and ``eigvalsh_tridiagonal_batch`` at B = 64, n = 4096 for
     every family -- with the kernels' launch counts zeroed just before and
     read just after, and checks every spectrum against scipy at
     64 * eps * max(1, ||T||_inf) (in worker processes, while the card
     works);
  4. checks batched == looped and the boundary rows of a padded n = 1000
     solve against numpy.linalg.eigh;
  6. drives the Sturm-count path, counts zeroed just before and read just
     after: ``eigvalsh_tridiagonal_range`` at n = 16384 (bottom 64, top
     64, the band [8160, 8224), and a select="v" window), ``kind="edges"``
     (k = 8) on every B = 64 x 4096 batch, ``method="bisect"`` at
     n = 4096, and ``certify=True`` and ``precision="mixed"`` at n = 16384
     and on the uniform and glued-Wilkinson batches; every spectrum is
     held to the phase-3 reference at 64 eps and every range result to
     the full BR solve at 8 eps, and each mixed solve is timed once (the
     glued batch escalates to native re-solves and takes minutes); a
     range solve on the card is compared
     with the same solve on the CPU, bit for bit (reported, not a gate);
  5. times the n = 16384 solve and the B = 64 batch, the Sturm path's
     range, bisect, certify and mixed solves (CUDA events, median of 5
     after a warm-up), then traces one run of the two main-path solves,
     the n = 16384 range solve and the two mixed solves with
     torch.profiler to split device time by kernel.

Every check raises on failure.  The last lines are a JSON record of the
kernels, the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
and prints no result.

The scipy reference is ``scipy.linalg.eigh_tridiagonal`` with its default
driver, except at eigenvalues where that and the port differ by more than
8 eps ||T||_inf: those are re-solved with the bisection driver ``stebz``
(the default driver is off by 88.6 eps ||T||_inf on a 4096-point uniform
problem against an extended-precision Sturm bisection, where stebz is off
by 0.64 -- scripts/torch_reference_check.py -- and stebz is too slow to
run on every eigenvalue).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates for the bound (NVIDIA H100 SXM data sheet, full 700 W
# limit): FP64 outside the tensor cores and FP32, and HBM bandwidth.
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

def _reference(d, e, lam, gap):
    """scipy's eigenvalues of (d, e), adjudicated by stebz wherever the
    default driver and ``lam`` differ by more than ``gap`` (runs in a
    worker process).  Returns (reference, indices re-solved)."""
    import numpy as np
    import scipy.linalg as sla
    ref = sla.eigh_tridiagonal(d, e, eigvals_only=True)
    disputed = np.nonzero(np.abs(ref - lam) > gap)[0]
    for k in disputed:
        ref[k] = sla.eigh_tridiagonal(
            d, e, eigvals_only=True, select="i", select_range=(k, k),
            lapack_driver="stebz")[0]
    return ref, disputed


def _tinf(d, e):
    import numpy as np
    row = np.abs(d).copy()
    row[:-1] += np.abs(e)
    row[1:] += np.abs(e)
    return float(row.max())


def _cuda_ms(torch, fn, reps=5):
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up,
    between CUDA events on the current stream."""
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


def _profile(torch, label, fn):
    """One traced run: the device time of each kernel (torch.profiler,
    CUPTI) against the run's wall time.  Prints "not measured" when the
    tracer records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        print(f"[5 profile] {label}: device time not measured (the tracer "
              f"recorded none); wall {wall_ms:.1f} ms")
        return
    top = "; ".join(f"{k[:60]} x{c} {ms:.2f} ms" for ms, k, c in rows[:6])
    print(f"[5 profile] {label}: wall {wall_ms:.1f} ms (traced), device "
          f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top: {top}")


def _cpu_range(src, d, e, il, iu):
    """The port's range solve on the CPU (runs in a worker process)."""
    sys.path.insert(0, src)
    from repro_torch.core import eigvalsh_tridiagonal_range
    return eigvalsh_tridiagonal_range(d, e, il=il, iu=iu,
                                      device="cpu").numpy()


def _sturm_ops(B, n, S, newton):
    """Floating-point operations of one count sweep: two subtractions and
    one division per (problem, shift, row); the derivative adds a
    multiply, an add, a division and the sum's add."""
    return float(B) * S * n * (7 if newton else 3)


def _sturm_bytes(B, n, S, newton, itemsize=8):
    """Each input read once (d, e2, shifts, pivmin), each output written
    once (int32 counts, plus the derivative sums)."""
    return (B * (2 * n - 1 + S + 1) * itemsize + B * S * 4
            + (B * S * itemsize if newton else 0))


def _secular_ops(kp, niter):
    """Operations per (root, pole) pair of the root solve: 1 (weight sum)
    + 3 (f(mid)) + 5 + 5 (the two model sweeps) + 6 per iteration + 4
    (final g); a division counts as one operation."""
    return float((kp.astype("float64") ** 2).sum()) * (18 + 6 * niter)


def _postpass_ops(kp, r):
    """Pass A (5 per pair) + pass B (5 + 2r per pair)."""
    return float((kp.astype("float64") ** 2).sum()) * (10 + 2 * r)


def _bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from repro_torch.core import (FAMILIES, SOLVE_COUNTER, SolveRequest,
                                  eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_batch,
                                  eigvalsh_tridiagonal_br,
                                  eigvalsh_tridiagonal_range,
                                  execute_request, make_family,
                                  make_family_batch)
    from repro_torch.core import bisect as bis
    from repro_torch.core import secular as sec
    from repro_torch.core import tune
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sturm_count import (chain_probe_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- phase 1: device and build --------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(["secular_roots", "fused_update",
                             "resident_merge", "sturm_count"])
    build_s = time.perf_counter() - t0
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1 ptxas] {name}: {line.strip()}")

    # ---- phase 2: every kernel against its plain version ----------------
    def problem(B, K, kprime, seed, dtype):
        rng = np.random.default_rng(seed)
        d = np.sort(rng.standard_normal((B, K)), axis=1)
        d[:, kprime:] += 10.0
        z = rng.standard_normal((B, K))
        z[:, kprime:] = 0.0
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
        return (t(d), t(z), torch.full((B,), 0.7, dtype=dtype, device=dev),
                torch.full((B,), kprime, dtype=torch.int32, device=dev))

    def tols(dtype):
        s = (float(np.finfo(np.float32).eps / np.finfo(np.float64).eps)
             if dtype == torch.float32 else 1.0)
        return 1e-13 * s, 1e-12 * s, 1e-10 * s

    nan_seen = []

    def excess(a, b, atol, rtol):
        """max |a - b| over the finite entries, and whether the two have
        NaN at the same entries and stay within atol + rtol |b| elsewhere.
        (Float32 weights can overflow their ratio product at K = 2048 --
        the JAX package does the same, ROADMAP Queue 3 -- so a NaN is
        held to the plain version's NaN.)"""
        nan = torch.isnan(b)
        same = bool(torch.equal(torch.isnan(a), nan))
        diff = torch.where(nan, torch.zeros_like(b), (a - b).abs())
        nan_seen.append(int(nan.sum()))
        return float(diff.max()), same and bool(
            (diff <= atol + rtol * torch.where(nan, 0.0, b).abs()).all())

    record = {}

    def report(name, dtype, shape, err, ok, k_ms, p_ms):
        tag = str(dtype).replace("torch.", "")
        nans = sum(nan_seen)
        nan_seen.clear()
        print(f"[2 kernel] {name} {tag} {shape}: max_abs_err {err:.3e} "
              f"kernel {k_ms:.3f} ms plain {p_ms:.3f} ms"
              + (f" ({nans} NaN in both, at the same entries)" if nans
                 else ""))
        if not ok:
            raise AssertionError(f"{name} {tag} {shape} disagrees with its "
                                 f"plain version (max_abs_err {err:.3e})")

    for dtype in (torch.float64, torch.float32):
        niter = ops.resolve_niter(None, dtype)
        lam_tol, atol, rtol = tols(dtype)
        tag = str(dtype).replace("torch.", "")
        print(f"[2 tolerance] {tag}: eigenvalues atol {lam_tol:.3e}; "
              f"weights and rows atol {atol:.3e} rtol {rtol:.3e}")
        # secular solve
        for B, K, kp in ((8, 1024, 1024), (8, 1024, 700), (1, 16384, 16384)):
            d, z, rho, kpr = problem(B, K, kp, seed=K + kp, dtype=dtype)
            z2 = z * z
            run_k = lambda: secular_solve_cuda(d, z2, rho, kpr,  # noqa: E731
                                               niter=niter)
            run_p = lambda: sec.secular_solve_batched(  # noqa: E731
                d, z2, rho, kpr, niter=niter, chunk=256)
            (ok_, tk), (op_, tp) = run_k(), run_p()
            err, ok = excess(sec.secular_eigenvalues(d, ok_, tk),
                             sec.secular_eigenvalues(d, op_, tp), lam_tol, 0)
            k_ms, p_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
            report("secular_roots", dtype, (B, K, kp), err, ok, k_ms, p_ms)
            if (B, K, tag) == (1, 16384, "float64"):
                kps = kpr.cpu().numpy()
                nbytes = (2 * 8 + 4 + 8) * B * K + 12 * B
                record["secular_roots"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                    flops=_secular_ops(kps, niter), nbytes=nbytes,
                    dtype=tag)
        # fused post-pass
        for r in (2, 3):
            B, K, kp = 8, 2048, 1536
            d, z, rho, kpr = problem(B, K, kp, seed=r, dtype=dtype)
            o, t = sec.secular_solve_batched(d, z * z, rho, kpr, niter=niter,
                                             chunk=256)
            R = torch.randn(B, r, K, dtype=dtype, device=dev)
            run_k = lambda: secular_postpass_cuda(  # noqa: E731
                R, d, z, o, t, kpr, rho)
            run_p = lambda: sec.secular_postpass_batched(  # noqa: E731
                R, d, z, o, t, kpr, rho, chunk=256)
            (zk, rk), (zp, rp) = run_k(), run_p()
            e1, ok1 = excess(zk, zp, atol, rtol)
            e2, ok2 = excess(rk, rp, atol, rtol)
            k_ms, p_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
            report("fused_update", dtype, (B, r, K, kp), max(e1, e2),
                   ok1 and ok2, k_ms, p_ms)
            if (r, tag) == (3, "float64"):
                kps = kpr.cpu().numpy()
                nbytes = ((2 * r + 4) * 8 + 4) * B * K + 12 * B
                record["fused_update"] = dict(
                    max_abs_err=max(e1, e2), ms=k_ms, plain_ms=p_ms,
                    flops=_postpass_ops(kps, r), nbytes=nbytes, dtype=tag)
        # resident merge (plain version in slices of 8 lanes: its dense
        # (K, K) tiles would take ~16 GB at once)
        threshold = tune.backend_defaults("cuda")["resident_threshold"]
        for K in (64, threshold):
            for r in (2, 3):
                B, kp = 64, (3 * K) // 4
                d, z, rho, kpr = problem(B, K, kp, seed=K + r, dtype=dtype)
                R = torch.randn(B, r, K, dtype=dtype, device=dev)
                run_k = lambda: resident_merge_cuda(  # noqa: E731
                    d, z, R, rho, kpr, niter=niter)

                def run_p():
                    outs = [sec.secular_merge_resident_batched(
                        d[s:s + 8], z[s:s + 8], R[s:s + 8], rho[s:s + 8],
                        kpr[s:s + 8], niter=niter) for s in range(0, B, 8)]
                    return tuple(torch.cat([o[i] for o in outs])
                                 for i in range(4))
                ka, pa = run_k(), run_p()
                e0, ok0 = excess(sec.secular_eigenvalues(d, *ka[:2]),
                                 sec.secular_eigenvalues(d, *pa[:2]),
                                 lam_tol, 0)
                e1, ok1 = excess(ka[2], pa[2], atol, rtol)
                e2, ok2 = excess(ka[3], pa[3], atol, rtol)
                k_ms, p_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
                report("resident_merge", dtype, (B, r, K, kp),
                       max(e0, e1, e2), ok0 and ok1 and ok2, k_ms, p_ms)
                if (K, r, tag) == (threshold, 3, "float64"):
                    kps = kpr.cpu().numpy()
                    nbytes = ((2 * r + 6) * 8 + 4) * B * K + 12 * B
                    record["resident_merge"] = dict(
                        max_abs_err=max(e0, e1, e2), ms=k_ms, plain_ms=p_ms,
                        flops=(_secular_ops(kps, niter)
                               + _postpass_ops(kps, r)),
                        nbytes=nbytes, dtype=tag)

    # Sturm counts: the certify sweep of the batched front door (B = 64,
    # n = 4096, S = 2n shifts) and one bisection trip of a range solve
    # (B = 1, n = 16384, k = 64).  Counts are integers and every operation
    # is rounded on its own, so the kernels must equal their plain
    # versions bit for bit (counts and derivative sums).
    d16, e16 = make_family("uniform", 16384, seed=0)
    batches = {f: make_family_batch(f, 4096, 64, seed0=100)
               for f in FAMILIES + ("glued_wilkinson",)}
    for (B, n, S, dtype) in ((64, 4096, 8192, torch.float64),
                             (1, 16384, 64, torch.float64),
                             (1, 16384, 64, torch.float32)):
        tag = str(dtype).replace("torch.", "")
        D, E = (batches["uniform"] if B == 64
                else (d16[None], e16[None]))
        d = torch.tensor(D, dtype=dtype, device=dev)
        e2 = torch.tensor(E, dtype=dtype, device=dev) ** 2
        piv = bis._pivot_floor(e2)
        lo = float(d.min()) - 2.5
        hi = float(d.max()) + 2.5
        x = torch.sort(lo + (hi - lo) * torch.rand(
            B, S, dtype=dtype, device=dev,
            generator=torch.Generator(device=dev).manual_seed(S)), dim=1
                       ).values
        x[:, 1] = x[:, 0]                   # a duplicate shift
        out = {}
        for newton in (False, True):
            name = "sturm_count_newton" if newton else "sturm_count"
            if newton:
                run_k = lambda: sturm_count_newton_cuda(  # noqa: E731
                    d, e2, x, piv[:, 0])
                run_p = lambda: bis._count_and_newton(  # noqa: E731
                    d, e2, x, piv)
            else:
                run_k = lambda: (sturm_count_cuda(  # noqa: E731
                    d, e2, x, piv[:, 0]),)
                run_p = lambda: (bis.sturm_count_plain(  # noqa: E731
                    d, e2, x, piv),)
            ka, pa = run_k(), run_p()
            same_counts = bool(torch.equal(ka[0], pa[0]))
            count_err = float((ka[0] - pa[0]).abs().max())
            err = (float((ka[1] - pa[1]).abs().max()) if newton
                   else count_err)
            bitwise = bool(torch.equal(ka[1], pa[1])) if newton else True
            k_ms = _cuda_ms(torch, run_k)
            p_ms = _cuda_ms(torch, run_p, 2)
            print(f"[2 kernel] {name} {tag} (B={B}, n={n}, S={S}): counts "
                  f"equal {same_counts}"
                  + (f", derivative sums bitwise {bitwise} (max_abs_err "
                     f"{err:.3e})" if newton else "")
                  + f"; kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
            if not same_counts:
                raise AssertionError(f"{name} {tag} counts differ from the "
                                     f"plain version")
            if newton and not (np.isfinite(err) and err <= 1e-12 * float(
                    pa[1].abs().max())):
                raise AssertionError(f"{name} {tag} derivative sums differ "
                                     f"beyond rounding: {err:.3e}")
            out[name] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err,
                             bitwise=bitwise)
        if tag == "float64":
            record[("sturm", B)] = dict(out, B=B, n=n, S=S,
                                        shift=float(x[0, S // 2]),
                                        count_at=int(ka[0][0, S // 2]))

    # The trip's latency bound: one shift's chain of n dependent rows on
    # one thread (same recurrence, loads kept off the chain), timed
    # between CUDA events and in SM cycles; its count must equal the
    # trip kernel's at that shift.
    trip = record[("sturm", 1)]
    d64 = torch.tensor(d16, dtype=torch.float64, device=dev)
    e64 = torch.tensor(e16, dtype=torch.float64, device=dev) ** 2
    piv64 = float(bis._pivot_floor(e64[None])[0, 0])
    run_c = lambda: chain_probe_cuda(  # noqa: E731
        d64, e64, trip["shift"], piv64)
    c_count, c_cycles = run_c()
    chain_ms = _cuda_ms(torch, run_c)
    if int(c_count) != trip["count_at"]:
        raise AssertionError(f"chain probe count {int(c_count)} != trip "
                             f"kernel count {trip['count_at']}")
    cycles_row = int(c_cycles) / trip["n"]
    trip.update(chain_ms=chain_ms, chain_ns_row=chain_ms * 1e6 / trip["n"],
                chain_cycles_row=cycles_row)
    trip_ms = trip["sturm_count"]["ms"]
    print(f"[2 chain] one shift's chain on one thread (n=16384, f64): "
          f"{chain_ms:.4f} ms, {trip['chain_ns_row']:.2f} ns and "
          f"{cycles_row:.1f} SM cycles per row (SM clock over the sweep "
          f"about {int(c_cycles) / (chain_ms * 1e3):.0f} MHz); one trip "
          f"(S=64) {trip_ms:.4f} ms = {trip_ms / chain_ms:.3f}x this chain "
          f"bound ({smi})")

    # ---- phase 3: the main path -----------------------------------------
    # scipy references run in worker processes while the card works;
    # they are collected before the timings of phase 5.
    eps = float(np.finfo(np.float64).eps)
    pool = ProcessPoolExecutor(max_workers=min(7, os.cpu_count() or 1),
                               mp_context=mp.get_context("spawn"))
    jobs = []

    def check_later(key, label, d, e, lam):
        scale = eps * max(1.0, _tinf(d, e))
        jobs.append((key, label, d, lam, scale,
                     pool.submit(_reference, d, e, lam, 8 * scale)))

    kernels = (secular_solve_cuda, secular_postpass_cuda,
               resident_merge_cuda)
    sturm_kernels = (sturm_count_cuda, sturm_count_newton_cuda)
    try:
        for k in kernels + sturm_kernels:
            k.launches = 0
        lam16 = eigvalsh_tridiagonal(d16, e16).cpu().numpy()
        per_solve = [k.launches for k in kernels]
        check_later("u16", "uniform n=16384", d16, e16, lam16)
        batch_lam = {}
        for fam, (D, E) in batches.items():
            lam = eigvalsh_tridiagonal_batch(D, E).eigenvalues.cpu().numpy()
            batch_lam[fam] = lam
            for b in range(D.shape[0]):
                check_later((fam, b), f"{fam} B=64 n=4096", D[b], E[b],
                            lam[b])
        launches = [k.launches for k in kernels]
        per_batch = [(a - b) / len(batches)
                     for a, b in zip(launches, per_solve)]
        print(f"[3 main] launches (secular_roots, fused_update, "
              f"resident_merge): n=16384 solve {per_solve}, B=64 x 4096 "
              f"batch (mean of {len(batches)}) {per_batch}, total "
              f"{launches}")
        if min(launches) == 0:
            raise AssertionError(f"a kernel of the main path never "
                                 f"launched: {launches}")

        # ---- phase 4: invariants (the references keep running) ---------
        D, E = make_family_batch("uniform", 1000, 4, seed0=7)
        bat = eigvalsh_tridiagonal_batch(D, E).eigenvalues
        loop = torch.stack([eigvalsh_tridiagonal(D[b], E[b])
                            for b in range(4)])
        diff = float((bat - loop).abs().max())
        bar = 64 * eps * max(1.0, max(_tinf(D[b], E[b]) for b in range(4)))
        if diff > bar:
            raise AssertionError(f"batched vs looped differ by {diff:.3e}")
        print(f"[4 invariant] batched vs looped (4 x n=1000): max diff "
              f"{diff:.3e}, bitwise {bool(torch.equal(bat, loop))}")
        d, e = make_family("normal", 1000, seed=8)
        res = eigvalsh_tridiagonal_br(d, e, return_boundary=True)
        w_ref, V = np.linalg.eigh(np.diag(d) + np.diag(e, 1)
                                  + np.diag(e, -1))
        row_err = max(
            float(np.abs(np.abs(res.blo.cpu().numpy())
                         - np.abs(V[0])).max()),
            float(np.abs(np.abs(res.bhi.cpu().numpy())
                         - np.abs(V[-1])).max()))
        lam_err = float(np.abs(res.eigenvalues.cpu().numpy() - w_ref).max())
        if row_err > 1e-10 or lam_err > 64 * eps * max(1.0, _tinf(d, e)):
            raise AssertionError(f"return_boundary n=1000: rows "
                                 f"{row_err:.3e}, eigenvalues {lam_err:.3e}")
        print(f"[4 invariant] return_boundary n=1000 (padded to 1024) vs "
              f"numpy.linalg.eigh rows up to sign: max {row_err:.3e}")

        # ---- phase 6: the Sturm-count path (references keep running) ---
        Du, Eu = batches["uniform"]
        src = os.path.join(HERE, "src")
        cpu_band = pool.submit(_cpu_range, src, Du[0], Eu[0], 2000, 2063)
        for k in kernels + sturm_kernels:
            k.launches = 0
        windows = {"bottom 64": (0, 63), "top 64": (16320, 16383),
                   "band [8160, 8224)": (8160, 8223)}
        sturm = {}
        per_range = None
        for name, (il, iu) in windows.items():
            before = [k.launches for k in sturm_kernels]
            sturm[name] = eigvalsh_tridiagonal_range(
                d16, e16, il=il, iu=iu).cpu().numpy()
            per_range = per_range or [k.launches - b for k, b in
                                      zip(sturm_kernels, before)]
        vl = 0.5 * (lam16[100] + lam16[101])
        vu = 0.5 * (lam16[160] + lam16[161])
        sturm["select v"] = eigvalsh_tridiagonal_range(
            d16, e16, select="v", vl=vl, vu=vu).cpu().numpy()
        edges = {fam: execute_request(SolveRequest(
            d=D, e=E, kind="edges", knobs={"k": 8})).eigenvalues.cpu(
            ).numpy() for fam, (D, E) in batches.items()}
        bis4096 = eigvalsh_tridiagonal(Du[0], Eu[0],
                                       method="bisect").cpu().numpy()
        card_band = eigvalsh_tridiagonal_range(Du[0], Eu[0], il=2000,
                                               iu=2063).cpu().numpy()
        robust = {}
        per_cert = {}
        mixed_s = {}
        for label, d, e, kind in (("n=16384", d16, e16, "full"),
                                  ("uniform B=64", Du, Eu, "batch"),
                                  ("glued_wilkinson B=64",
                                   *batches["glued_wilkinson"], "batch")):
            before = sturm_count_cuda.launches
            robust[f"certify {label}"] = (execute_request(SolveRequest(
                d=d, e=e, kind=kind, certify=True)), None)
            per_cert[label] = sturm_count_cuda.launches - before
            # One timed run each (the glued batch's escalations take
            # minutes, too long for a median of 5).
            t0 = time.perf_counter()
            with SOLVE_COUNTER.measure(refinement=True) as win:
                res = execute_request(SolveRequest(
                    d=d, e=e, kind=kind, knobs={"precision": "mixed"}))
            torch.cuda.synchronize()
            mixed_s[f"mixed {label}"] = time.perf_counter() - t0
            robust[f"mixed {label}"] = (res, win.refinement_stats)
        sturm_launches = [k.launches for k in sturm_kernels]
        tree_launches = [k.launches for k in kernels]
        print(f"[6 sturm] launches (sturm_count, sturm_count_newton): "
              f"per n=16384 range solve (k=64) {per_range}; per certify "
              f"sweep {per_cert}; phase total {sturm_launches}; merge "
              f"kernels (secular_roots, fused_update, resident_merge) in "
              f"the phase (mixed and certified trees) {tree_launches}")
        if min(sturm_launches) == 0:
            raise AssertionError(f"a Sturm kernel never launched on its "
                                 f"path: {sturm_launches}")
        for label, (res, rstats) in robust.items():
            diag = res.diagnostics or {}
            tally = (f"certified {diag['certified']} of {diag['lanes']} "
                     f"lanes" if "certified" in diag else "")
            pol = (f"polished {rstats['polished']} of {rstats['targets']} "
                   f"in {rstats['iterations']} sweeps, "
                   f"{rstats['max_rounds']} round(s)" if rstats else "")
            wall = (f"; wall {mixed_s[label]:.2f} s (one run, {smi})"
                    if label in mixed_s else "")
            print(f"[6 robust] {label}: {tally}{pol}; escalations "
                  f"{diag.get('escalations', 'none')}{wall}")

        worst = {}
        refs = {}
        for key, label, d, lam, scale, fut in jobs:
            ref, redo = fut.result()
            refs[key] = (ref, scale)
            if not (np.isfinite(lam).all() and lam.shape == d.shape):
                raise AssertionError(f"{label}: bad output")
            err = np.abs(lam - ref) / scale
            ratio = float(err.max())
            w = worst.setdefault(label, [0.0, 0, 0.0])
            w[0] = max(w[0], ratio)
            w[1] += len(redo)
            w[2] = max(w[2], float(err[redo].max()) if len(redo) else 0.0)
            if ratio > 64:
                raise AssertionError(f"{label}: max error {ratio:.2f} "
                                     f"eps*||T||_inf, above the bar of 64")
        band_cpu = cpu_band.result()
    finally:
        pool.shutdown(cancel_futures=True)
    for label, (ratio, redo, redo_err) in worst.items():
        print(f"[3 main] {label}: max error {ratio:.2f} eps*||T||_inf vs "
              f"scipy (bar 64); {redo} eigenvalues where the default driver "
              f"differs by > 8 were re-solved with stebz, max error there "
              f"{redo_err:.2f}")

    # ---- phase 6 checks: every Sturm-path spectrum vs the references ----
    held = {}

    def hold(label, got, key, sl, br=None):
        """got vs the phase-3 reference at 64 eps and, for range results,
        vs the full BR solve ``br`` at 8 eps."""
        ref, scale = refs[key]
        ref = ref[sl]
        if not (got.shape == ref.shape and np.isfinite(got).all()):
            raise AssertionError(f"{label}: bad output {got.shape}")
        r64 = float(np.abs(got - ref).max()) / scale if got.size else 0.0
        r8 = (float(np.abs(got - br[sl]).max()) / scale
              if br is not None and got.size else None)
        w = held.setdefault(label, [0.0, None])
        w[0] = max(w[0], r64)
        if r8 is not None:
            w[1] = max(w[1] or 0.0, r8)
        if r64 > 64 or (r8 is not None and r8 > 8):
            raise AssertionError(f"{label}: {r64:.2f} eps*||T||_inf from "
                                 f"the reference (bar 64), {r8} from the "
                                 f"BR solve (bar 8)")

    for name, (il, iu) in windows.items():
        hold(f"range {name} n=16384", sturm[name], "u16",
             slice(il, iu + 1), lam16)
    ref16 = refs["u16"][0]
    start = int(np.count_nonzero(ref16 <= vl))
    hits = int(np.count_nonzero((ref16 > vl) & (ref16 <= vu)))
    if len(sturm["select v"]) != hits or hits != 60:
        raise AssertionError(f"select v: {len(sturm['select v'])} "
                             f"eigenvalues in (vl, vu], reference {hits}")
    hold("range select v n=16384", sturm["select v"], "u16",
         slice(start, start + hits), lam16)
    for fam, got in edges.items():
        for b in range(64):
            hold(f"edges k=8 {fam} B=64", got[b], (fam, b), slice(0, 8),
                 batch_lam[fam][b])
            hold(f"edges k=8 {fam} B=64", got[64 + b], (fam, b),
                 slice(4088, 4096), batch_lam[fam][b])
    hold("bisect n=4096 uniform", bis4096, ("uniform", 0), slice(None))
    for label, (res, _) in robust.items():
        lam = res.eigenvalues.cpu().numpy()
        if lam.ndim == 1:
            hold(label, lam, "u16", slice(None))
        else:
            fam = label.split()[1]
            for b in range(lam.shape[0]):
                hold(label, lam[b], (fam, b), slice(None))
    for label, (r64, r8) in held.items():
        print(f"[6 sturm] {label}: max error {r64:.2f} eps*||T||_inf vs the "
              f"reference (bar 64)"
              + (f", {r8:.2f} vs the full BR solve (bar 8)"
                 if r8 is not None else ""))
    diff = np.abs(card_band - band_cpu)
    print(f"[6 sturm] range [2000, 2064) of a uniform n=4096 problem, card "
          f"vs CPU: bitwise {bool(np.array_equal(card_band, band_cpu))}, "
          f"max diff {float(diff.max()):.3e} (reported, not a gate)")

    # ---- phase 5: timings -----------------------------------------------
    t16 = _cuda_ms(torch, lambda: eigvalsh_tridiagonal(d16, e16))
    t64 = _cuda_ms(torch, lambda: eigvalsh_tridiagonal_batch(Du, Eu))
    print(f"[5 time] eigvalsh_tridiagonal n=16384 uniform f64: {t16:.1f} ms;"
          f" eigvalsh_tridiagonal_batch B=64 n=4096 uniform f64: "
          f"{t64:.1f} ms (median of 5, {smi})")
    sturm_paths = {
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
                                                       precision="mixed"),
        "certify, B=64 x 4096": lambda: eigvalsh_tridiagonal(
            Du, Eu, certify=True),
        "mixed, B=64 x 4096": lambda: eigvalsh_tridiagonal(
            Du, Eu, precision="mixed")}
    for label, fn in sturm_paths.items():
        print(f"[5 time] {label} uniform f64: {_cuda_ms(torch, fn):.1f} ms "
              f"(median of 5, {smi})")

    _profile(torch, "n=16384 uniform solve",
             lambda: eigvalsh_tridiagonal(d16, e16))
    _profile(torch, "B=64 n=4096 uniform batch",
             lambda: eigvalsh_tridiagonal_batch(Du, Eu))
    _profile(torch, "range bottom 64, n=16384", sturm_paths[
        "range bottom 64, n=16384"])
    _profile(torch, "mixed, n=16384", sturm_paths["mixed, n=16384"])
    _profile(torch, "mixed, B=64 x 4096", sturm_paths["mixed, B=64 x 4096"])

    sources = {"secular_roots": ("src/repro_torch/csrc/secular_roots.cu",
                                 "src/repro/kernels/secular_roots.py:265"),
               "fused_update": ("src/repro_torch/csrc/fused_update.cu",
                                "src/repro/kernels/fused_update.py:234"),
               "resident_merge": ("src/repro_torch/csrc/resident_merge.cu",
                                  "src/repro/kernels/resident_merge.py:225")}
    out = []
    for (name, (src, tpu)), count in zip(sources.items(), launches):
        rec = record[name]
        bound, by = _bound_ms(rec["flops"], rec["nbytes"], rec["dtype"])
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": tpu, "launches": int(count),
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": bound,
                    "bound_by": by, "library_ms": None})
    st = record[("sturm", 64)]
    bounds = {}
    for key, r in (("certify", st), ("trip", trip)):
        for newton in (False, True):
            bounds[key, newton] = _bound_ms(
                _sturm_ops(r["B"], r["n"], r["S"], newton),
                _sturm_bytes(r["B"], r["n"], r["S"], newton), "float64")
    count, newton = st["sturm_count"], st["sturm_count_newton"]
    out.append({
        "name": "sturm_count", "route": "cuda",
        "source": "src/repro_torch/csrc/sturm_count.cu",
        "replaces": "src/repro/kernels/sturm_count.py:63",
        "launches": int(sturm_launches[0]),
        "max_abs_err": count["max_abs_err"], "ms": count["ms"],
        "plain_ms": count["plain_ms"], "bound_ms": bounds["certify", 0][0],
        "bound_by": bounds["certify", 0][1], "library_ms": None,
        "shape": "B=64 n=4096 S=8192 f64",
        "launches_newton": int(sturm_launches[1]),
        "newton_ms": newton["ms"], "newton_plain_ms": newton["plain_ms"],
        "newton_max_abs_err": newton["max_abs_err"],
        "newton_bitwise": newton["bitwise"],
        "newton_bound_ms": bounds["certify", 1][0],
        "trip_shape": "B=1 n=16384 S=64 f64",
        "trip_ms": trip["sturm_count"]["ms"],
        "trip_plain_ms": trip["sturm_count"]["plain_ms"],
        "trip_bound_ms": bounds["trip", 0][0],
        "trip_chain_bound_ms": trip["chain_ms"],
        "chain_ns_per_row": trip["chain_ns_row"],
        "chain_cycles_per_row": trip["chain_cycles_row"],
        "trip_newton_ms": trip["sturm_count_newton"]["ms"],
        "trip_newton_plain_ms": trip["sturm_count_newton"]["plain_ms"],
        "trip_chain_rows": trip["n"]})
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
