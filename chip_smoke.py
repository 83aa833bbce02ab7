#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the eight CUDA sources from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel), then:

  1. prints the card (``nvidia-smi`` name and power limit), the CUDA
     version and the build time;
  2. holds each kernel against its plain torch version on the card at the
     main path's shapes, in float64 and float32 (tolerances of
     tests/test_kernels.py, float32 scaled by eps, and scaled by K for
     the row update's r > 4 sums; the Sturm counts and their derivative
     sums bit for bit; the QL kernel at 64 eps ||T||_inf against its plain
     loop on the CPU), timing both, and the row update beside
     torch.matmul of a pre-formed Y (the product only); times one shift's
     Sturm chain on one thread (the latency bound of a bisection trip),
     holds the bisection tree (one launch: up to eight halvings of every
     bracket) to its plain version bit for bit at a range solve's
     brackets (B = 1, n = 16384, k = 64, depth 8) and the edges probes'
     (B = 128, n = 4096, k = 8), in float64 and float32, and times each
     launch beside the chain probe, and
     QL's rotation chain on one thread (the chain probe: QL's chain bound
     at n = 4096); prints the launch design of the root solve, the
     resident merge, the row update and the QL kernel (team and cluster
     sizes, tiles and paths, shared memory, registers and spills, and the
     DMMA instructions of the row update's tensor-core path) and times the
     merge kernels' library yardstick, torch.linalg.eigvalsh of the
     pre-formed diag(d) + rho z z^T, at the kernel table's shapes; prints
     the team, block and tile of the weight kernel (zhat, and the fused
     post-pass's pass A) and of the post-pass's pass B, holds zhat to its
     plain version at K = 16384 too and the post-pass at the levels the
     main path gives it (r = 2 at W = 4 x K = 4096 and W = 2 x K = 8192),
     and reads the FP64-pipe and all instructions of the hot loops of
     zhat, the post-pass, the Sturm counts and the bisection tree from
     their SASS (times at the SM clock the Sturm chain probe measures),
     and from the tree's the node chains that issue within one chain's
     latency (the depth rule's ``bisect_chains``); holds
     the deflation chain kernel to the plain chain run on the card, bit
     for bit, on real merge lanes (glued Wilkinson and uniform, W = 64 x
     K = 2048 and W = 1 x K = 16384, r = 3; r = K = 512; the r = K =
     2048 and 4096 levels of a glued n = 4096 lazy solve, on the split
     route) and the edge cases, in float64 and float32, prints its
     routes, launch shapes, registers and spills, and times one dependent
     step of its chain on one warp (the chain probe);
  3. drives the main path -- ``eigvalsh_tridiagonal`` at n = 16384
     (uniform) and ``eigvalsh_tridiagonal_batch`` at B = 64, n = 4096 for
     every family -- with the kernels' launch counts zeroed just before and
     read just after (the deflation chain once per merge level), and
     checks every spectrum against scipy at
     64 * eps * max(1, ||T||_inf) (in worker processes, while the card
     works);
  4. checks batched == looped, at 64 eps and then bit for bit, and the
     boundary rows of a padded n = 1000 solve against numpy.linalg.eigh;
  6. drives the Sturm-count path, counts zeroed just before and read just
     after: ``eigvalsh_tridiagonal_range`` at n = 16384 (bottom 64, top
     64, the band [8160, 8224), and a select="v" window), ``kind="edges"``
     (k = 8) on every B = 64 x 4096 batch, ``method="bisect"`` at
     n = 4096, and ``certify=True`` and ``precision="mixed"`` at n = 16384
     and on the uniform and glued-Wilkinson batches; every spectrum is
     held to the phase-3 reference at 64 eps and every range result to
     the full BR solve at 8 eps; the n = 16384 range solve must take no
     single-halving count sweep, 2 Newton sweeps and at most 7 tree
     launches; each mixed solve is timed once (the
     glued batch escalates to native re-solves and takes minutes); a
     range solve on the card is compared
     with the same solve on the CPU, bit for bit (reported, not a gate);
  7. drives the paper's comparison points, counts zeroed just before and
     read just after: ``method`` in sterf, lazy, full, eigh and br, and
     br with ``fused=False``, at n = 4096 (uniform and glued Wilkinson,
     ``certify=True`` on lazy), the B = 64 x 4096 uniform batch with and
     without ``fused=False``, and br, ``fused=False`` br, lazy, full and
     sterf at n = 16384 (sterf at n = 8192 when its n = 4096 time
     predicts over 120 s), each timed (CUDA events; median of 5 for the
     BR routes, one run for the others) with its own peak device memory
     printed beside the matching ``workspace_model_*`` (and the leaf
     solve's peak alone); every spectrum is held to the phase-3 reference
     at 64 eps, sterf's at max(64, 3 sqrt(n)) eps (QL's error grows as
     sqrt(n), the JAX package's QL's too: see _sterf_bar); the QL kernel
     is held to its plain loop at n = 4096 and timed beside
     torch.linalg.eigvalsh of the pre-formed dense T;
  5. times the n = 16384 solve and the B = 64 batch, a glued-Wilkinson
     n = 4096 solve and B = 64 x 4096 batch, the Sturm path's range,
     bisect, certify and mixed solves (CUDA events, median of 5 after a
     warm-up), then traces one run of the two main-path solves, the glued
     n = 4096 solve, the n = 16384 range solve and the two mixed solves
     with torch.profiler to split device time by kernel;
  8. drives the eigensolver service (``repro_torch.serve``) on the card:
     prewarms the buckets through ``EigensolverClient(prewarm=...)``,
     sends sixteen threads' mixed traffic (n = 4096 singles, uniform and
     glued Wilkinson; B = 8 batches of n in 3000-4096 with boundary rows;
     n = 16384 singles; n = 16384 range windows, k = 64; B = 4 x 4096
     edges probes, k = 8; certified n = 4096 singles) with the kernels'
     launch counts zeroed just before and read just after, holds every
     served result to the sync API on the card bit for bit (diagnostics
     too, none on the CPU), checks 0 errors, fallbacks and retries, a
     coalesce factor above 1 and no plan-cache miss after the prewarm;
     runs two chaos cases (a transient ``serve.launch`` error, retried
     once; a ``plan.output``-poisoned member, escalated as its sync solve
     is); and times 64 x 4096 problems served as 64 concurrent requests,
     as one batch call and as a loop of 64 sync calls, with each flush's
     wall time, host time in the launch and in the leaf's
     ``torch.linalg.eigh``, and stream span (CUDA events);
  9. tunes and drives ``spectral/`` and ``optim/`` on the card, the
     kernels' launch counts zeroed just before and read just after: runs
     ``plan.tune`` (``$REPRO_TUNE_CACHE`` pointed at a temporary
     directory, 3 timed rounds) on a B = 64 x 4096 solve, an n = 16384
     k = 64 range solve and 64 n = 4096 requests served from 16 threads,
     prints each winner with its default and tuned host wall, then checks
     that a fresh consult carries the winners, that the B = 64 x 4096
     batch with None knobs equals the batch with the same knobs given
     explicitly bit for bit and holds the phase-3 reference at 64 eps,
     and that ``plan_cache_stats()`` counts tuned routes, and restores
     the cache; runs ``slq_spectrum`` (4 probes, m = 64, leaf 8) on the
     Hessian-vector product (``make_hvp``) of a float32 tanh MLP with 2^24
     weights and a fixed batch made on the card, directly and through an
     ``EigensolverClient`` (``kind="slq"``), equal bit for bit, its nodes
     within 64 eps of stebz on the same Krylov tridiagonals and each
     probe's weights summing to 1 within 1e-12, and ``sharpness`` (m = 16)
     direct and served, equal bit for bit; holds ``slq_spectrum`` on a
     diagonal operator of 2^24 set eigenvalues (a bulk in [0.1, 1] and the
     isolated ends -0.5 and 2.0) to its ends within 1e-4 and to its trace
     within 1e-5 relative; and takes 20 ``adamw`` steps on the MLP with the
     spectral governor's ``lr_scale``, probing every 5 steps through the
     client, each served probe equal to a direct one bit for bit, its
     target below the MLP's lam_max so that each scale is
     max(min_scale, target / lam_max) strictly below 1, the first step's
     update that scale times the ungoverned one, and the loss falling.

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
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates for the bound (NVIDIA H100 SXM data sheet, full 700 W
# limit): FP64 outside the tensor cores and FP32, FP64 on the tensor cores
# (DMMA), and HBM bandwidth.
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_FP64_TENSOR = 67e12
PEAK_BYTES = 3.35e12

# A method at n = 16384 whose predicted time exceeds this runs at n = 8192.
CUT_S = 120.0


def _sterf_bar(n):
    """sterf's bar in eps * max(1, ||T||_inf): the conformance bar of 64,
    or 3 sqrt(n) where that is larger.  QL as the JAX package writes it
    (NR tqli's split test, unscaled rotations) errs by 0.97-1.31 sqrt(n)
    against stebz at n = 1024-16384 (the JAX package's own sterf 40.72 and
    77.09 at n = 1024 and 4096 -- scripts/torch_reference_check.py
    sterf_growth -- and this script's phase 7), and the kernel and the
    plain loop part by 1.59 sqrt(n) at n = 4096."""
    return max(64.0, 3.0 * n ** 0.5)

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


def _plain_sterf(src, d, e):
    """The port's plain QL loop on the CPU (runs in a worker process):
    (eigenvalues, seconds)."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.core.sterf import sterf_plain
    t0 = time.perf_counter()
    lam, _ = sterf_plain(torch.tensor(d)[None], torch.tensor(e)[None])
    return lam[0].numpy(), time.perf_counter() - t0


def _cuda_once(torch, fn):
    """(result, milliseconds) of one call of ``fn`` between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _dense_y(torch, d, w, origin, tau, kprime):
    """The normalized secular eigenvector blocks Y (B, K, K) that the row
    update never forms (deflated columns identity): R @ Y is the update."""
    B, K = d.shape
    d_org = torch.gather(d, 1, origin.long())
    active = torch.arange(K, device=d.device)[None, :] < kprime[:, None]
    delta = (d[:, :, None] - d_org[:, None, :]) - tau[:, None, :]
    act_i = active[:, :, None]
    Y = torch.where(act_i, w[:, :, None] / torch.where(
        act_i & (delta != 0), delta, torch.ones_like(delta)),
        torch.zeros_like(delta))
    del delta
    nrm = torch.sqrt((Y * Y).sum(1))
    Y /= torch.where(nrm > 0, nrm, torch.ones_like(nrm))[:, None, :]
    eye = torch.eye(K, dtype=d.dtype, device=d.device)
    return torch.where(active[:, None, :], Y, eye)


def _zhat_ops(kp):
    """Per (active pole, active root) pair of the ratio product: three
    subtractions, one division and one multiplication."""
    return float((kp.astype("float64") ** 2).sum()) * 5


def _boundary_ops(kp, r):
    """Per (active pole, active root) pair: the difference (2), one
    division, r multiply-adds (2r) and the norm's (2).  Returns (FMA
    operations of the product, the rest)."""
    pairs = float((kp.astype("float64") ** 2).sum())
    return pairs * 2 * r, pairs * 5


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


def _tree_bytes(B, n, k, itemsize=8):
    """m halvings' inputs read once (d, e2, pivmin, tol, int32 targets,
    lo, hi) and outputs written once (lo, hi).  The node counts the
    kernel also writes are its own by-product: no caller reads them."""
    return B * (2 * n + 1) * itemsize + B * k * (4 + 4 * itemsize)


def _live_halvings(lo, hi, tol, targets, counts, steps):
    """Halvings that ``steps`` trips of the bisection loop take from the
    brackets (lo, hi): the brackets still wider than tol at each step,
    walked down the tree's node counts with the loop's rule (a bracket
    that converged takes no more).  One count sweep of n rows each."""
    import torch
    node = torch.zeros(lo.shape + (1,), dtype=torch.int64,
                       device=lo.device)
    live_steps = 0
    for _ in range(steps):
        live = (hi - lo) > tol
        live_steps += int(live.sum())
        mid = 0.5 * (lo + hi)
        above = torch.gather(counts, 2, node)[..., 0] > targets
        hi = torch.where(above & live, mid, hi)
        lo = torch.where(~above & live, mid, lo)
        node = 2 * node + 1 + (~above)[..., None].to(torch.int64)
    return live_steps


def _secular_ops(kp, niter):
    """Operations per (root, pole) pair of the root solve: 1 (weight sum)
    + 3 (f(mid)) + 5 + 5 (the two model sweeps) + 6 per iteration + 4
    (final g); a division counts as one operation."""
    return float((kp.astype("float64") ** 2).sum()) * (18 + 6 * niter)


def _postpass_ops(kp, r):
    """Pass A (5 per pair) + pass B (5 + 2r per pair)."""
    return float((kp.astype("float64") ** 2).sum()) * (10 + 2 * r)


def _window_steps(small, defl, window=32):
    """Dependent steps of each lane of the deflation chain kernel, read
    from its result: the kernel tests ``window`` poles at a time and
    restarts after the first rotation in a window, and the rotations' own
    poles are the kept poles after the rotation-deflated ones.  small,
    defl: (W, K) numpy bool.  Returns (W,) numpy int."""
    import numpy as np
    W, K = small.shape
    out = np.zeros(W, dtype=np.int64)
    for w in range(W):
        kept = np.flatnonzero(~small[w])
        fired = kept[np.searchsorted(kept, np.flatnonzero(
            defl[w] & ~small[w]), side="right")]
        start = k = 0
        while start < K:
            out[w] += 1
            while k < len(fired) and fired[k] < start:
                k += 1
            if k < len(fired) and fired[k] < start + window:
                start = int(fired[k]) + 1
            else:
                start += window
    return out


def _bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _ptxas(log):
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from an ``nvcc -Xptxas -v`` log, keyed by the demangled-enough name
    (the kernel's name and its T: ``...kernelIdE`` is double)."""
    import re
    out = {}
    name = None
    spill = (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def _regs(log, key):
    """(registers, spill stores, spill loads) of the one kernel whose
    mangled name contains ``key`` in a ptxas log (``...kernelIdE``: the
    kernel's float64 instance)."""
    hits = [v for fn, v in _ptxas(log).items() if key in fn]
    if len(hits) != 1:
        raise AssertionError(f"{len(hits)} ptxas entries match {key}")
    return hits[0]


def _constants(path, names):
    """{name: value} of the ``constexpr int NAME = value;`` lines of a
    CUDA source: the launch design the kernel is compiled with."""
    import re
    text = open(path).read()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names}


def _instr_bounds_ms(counts, items, sm_hz, sms):
    """(FP64-pipe bound, issue-slot time) in ms of ``items`` items of
    ``counts`` = (FP64-pipe instructions, all instructions) each: an SM
    runs two FP64 warp instructions (64 lanes) and issues four warp
    instructions (128 lanes) a cycle, at the SM clock ``sm_hz``.  (None,
    None) where the SASS was not read."""
    if not counts:
        return None, None
    return tuple(c * items / (sms * lanes * sm_hz) * 1e3
                 for c, lanes in zip(counts, (64, 128)))



def _phase8(torch, np, smi):
    """Phase 8: the eigensolver service on the card (see the module
    docstring).  Raises on any failed check; returns the phase's launch
    counts by kernel name."""
    from repro_torch.core import (SolveRequest, eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_batch,
                                  execute_request, make_family,
                                  plan_cache_stats)
    from repro_torch.core import br_dc
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.runtime import FaultSpec, configure_faults, reset_faults
    from repro_torch.serve import EigensolverClient

    t_phase = time.perf_counter()
    engine_thread = "repro-torch-serve-engine"
    # The leaf's host time: every torch.linalg.eigh call the engine
    # thread makes, as (start, end) on the perf_counter clock.
    leaf_spans = []
    real_leaf = br_dc._leaf_eigh

    def timed_leaf(*args):
        t0 = time.perf_counter()
        out = real_leaf(*args)
        if threading.current_thread().name == engine_thread:
            leaf_spans.append((t0, time.perf_counter()))
        return out

    br_dc._leaf_eigh = timed_leaf

    rng = np.random.default_rng(2020)
    n4, n16 = 4096, 16384

    def fam(i):
        return ("uniform", "glued_wilkinson")[i % 2]

    singles = [make_family(fam(i), n4, seed=800 + i) for i in range(64)]
    batches = []
    for i in range(8):
        n = int(rng.integers(3000, n4 + 1))
        D, E = zip(*(make_family(fam(i + j), n, seed=900 + 8 * i + j)
                     for j in range(8)))
        batches.append((np.stack(D), np.stack(E)))
    bigs = [make_family(("uniform", "normal")[i % 2], n16, seed=1000 + i)
            for i in range(4)]
    windows = [(bigs[i // 2], 0 if i % 2 == 0 else n16 - 64)
               for i in range(8)]
    probes = []
    for i in range(16):
        D, E = zip(*(make_family(fam(i + j), n4, seed=1100 + 4 * i + j)
                     for j in range(4)))
        probes.append((np.stack(D), np.stack(E)))
    certs = [make_family(fam(i), n4, seed=1200 + i) for i in range(16)]

    reqs = ([("single", SolveRequest(d=d, e=e)) for d, e in singles]
            + [("batch", SolveRequest(d=D, e=E, kind="batch",
                                      return_boundary=True))
               for D, E in batches]
            + [("big", SolveRequest(d=d, e=e)) for d, e in bigs]
            + [("range", SolveRequest(d=d, e=e, kind="range", il=il,
                                      iu=il + 63))
               for (d, e), il in windows]
            + [("edges", SolveRequest(d=D, e=E, kind="edges",
                                      knobs={"k": 8}))
               for D, E in probes]
            + [("certify", SolveRequest(d=d, e=e, certify=True))
               for d, e in certs])

    def send(client, req):
        """Each kind through the client's own front door."""
        kind, r = req
        if kind in ("single", "big"):
            return client.solve_async(r.d, r.e)
        if kind == "batch":
            return client.solve_batch_async(r.d, r.e, return_boundary=True)
        if kind == "range":
            return client.solve_range_async(r.d, r.e, il=r.il, iu=r.iu)
        if kind == "certify":
            return client.solve_async(r.d, r.e, certify=True)
        return client.submit(r)

    def burst(client, items, threads=16):
        """Submit ``items`` from ``threads`` threads; returns the futures
        in item order."""
        futs = [None] * len(items)

        def worker(k):
            for i in range(k, len(items), threads):
                futs[i] = send(client, items[i])

        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return futs

    pow2 = (1, 2, 4, 8, 16, 32, 64)
    spec = ([{"kind": "solve", "n": n4, "batch": b} for b in pow2]
            + [{"kind": "solve", "n": n4, "batch": b,
                "return_boundary": True} for b in pow2[3:]]
            + [{"kind": "full", "n": n16, "batch": b} for b in pow2[:3]]
            + [{"kind": "range", "n": n16, "k": 64, "batch": b}
               for b in pow2[:4]]
            + [{"kind": "edges", "n": n4, "k": 8, "batch": b}
               for b in (4, 8, 16, 32)])
    kernels = {"resident_merge": resident_merge_cuda,
               "secular_roots": secular_solve_cuda,
               "fused_update": secular_postpass_cuda,
               "deflate_chain": deflate_chain_cuda,
               "sturm_count": sturm_count_cuda,
               "sturm_count_newton": sturm_count_newton_cuda,
               "sturm_bisect_tree": sturm_bisect_tree_cuda}
    try:
        t0 = time.perf_counter()
        client = EigensolverClient(max_batch=64, max_wait_us=5000,
                                   prewarm=spec)
        prewarm_s = time.perf_counter() - t0
        try:
            before = plan_cache_stats()
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            futs = burst(client, reqs)
            got = [f.result(timeout=600) for f in futs]
            traffic_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
            after = plan_cache_stats()
            snap = client.metrics()["buckets"]
            flushes = list(client.engine.flush_log)
        finally:
            client.close()
        print(f"[8 serve] prewarm of {len(spec)} plans (kernels built "
              f"first) {prewarm_s:.2f} s; traffic of {len(reqs)} requests "
              f"from 16 threads {traffic_s:.3f} s wall ({smi})")
        print(f"[8 serve] launches in the served traffic: {launches}")
        for name in ("resident_merge", "secular_roots", "fused_update",
                     "deflate_chain", "sturm_count"):
            if launches[name] == 0:
                raise AssertionError(f"serve: {name} never launched")
        for key in ("misses", "range_misses", "executor_traces",
                    "range_executor_traces"):
            if after[key] != before[key]:
                raise AssertionError(f"serve: the traffic added plan-cache "
                                     f"{key}: {before[key]} -> "
                                     f"{after[key]}")
        for label, b in sorted(snap.items()):
            print(f"[8 serve] bucket {label}: requests {b['requests']}, "
                  f"flushes {b['flushes']}, coalesce factor "
                  f"{b['coalesce_factor']:.2f}, errors {b['errors']}, "
                  f"fallbacks {b['fallbacks']}, retries {b['retries']}, "
                  f"latency p50 {b['latency_p50_ms']:.1f} ms, p99 "
                  f"{b['latency_p99_ms']:.1f} ms, flush p50 "
                  f"{b['flush_p50_ms']:.1f} ms")
        bad = {k: sum(b[k] for b in snap.values())
               for k in ("errors", "fallbacks", "retries")}
        if any(bad.values()):
            raise AssertionError(f"serve: clean traffic had {bad}")
        if not snap["solve/N4096/float64"]["coalesce_factor"] > 1.0:
            raise AssertionError("serve: solve/N4096/float64 never "
                                 "coalesced")

        # served == sync, bit for bit, on the card
        t0 = time.perf_counter()
        refs = [execute_request(r) for _, r in reqs]
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        for (kind, _), g, r in zip(reqs, got, refs):
            for name in ("eigenvalues", "blo", "bhi"):
                a, b = getattr(g, name), getattr(r, name)
                if a is None and b is None:
                    continue
                if a is None or b is None or not a.is_cuda:
                    raise AssertionError(f"serve {kind}: {name} is "
                                         f"{a if a is None else a.device}")
                if a.dtype != b.dtype or not torch.equal(a, b):
                    diff = float((a.double() - b.double()).abs().max())
                    raise AssertionError(f"serve {kind}: {name} differs "
                                         f"from the sync API by {diff:.3e}")
            if g.diagnostics != r.diagnostics:
                raise AssertionError(f"serve {kind}: diagnostics "
                                     f"{g.diagnostics} != {r.diagnostics}")
        print(f"[8 serve] every served result == the sync API on the card, "
              f"bit for bit with equal diagnostics ({len(reqs)} requests; "
              f"the sync loop took {sync_s:.3f} s); none on the CPU")

        # chaos on the card
        probs = [SolveRequest(d=d, e=e) for d, e in singles[:8]]
        configure_faults([FaultSpec(site="serve.launch", kind="error",
                                    times=(0,), error="transient")])
        with EigensolverClient(max_batch=64, max_wait_us=50_000,
                               retries=1, retry_backoff_s=0.01) as c:
            res = [f.result(timeout=600)
                   for f in [c.solve_async(r.d, r.e) for r in probs]]
            b = c.metrics()["buckets"]["solve/N4096/float64"]
        reset_faults()
        if not (b["retries"] == 1 and b["fallbacks"] == 0
                and b["errors"] == 0):
            raise AssertionError(f"serve chaos (transient launch): {b}")
        for g, r in zip(res, refs[:8]):
            if not torch.equal(g.eigenvalues, r.eigenvalues):
                raise AssertionError("serve chaos (transient launch): "
                                     "a result changed")
        print(f"[8 chaos] transient serve.launch error: retried once "
              f"(retries {b['retries']}, fallbacks {b['fallbacks']}, errors "
              f"{b['errors']}), {len(res)} results bit for bit")
        configure_faults([FaultSpec(site="plan.output", kind="nan",
                                    times=(0,), lane=1, width=1)])
        with EigensolverClient(max_batch=64, max_wait_us=200_000) as c:
            futs = [c.solve_async(r.d, r.e) for r in probs[:4]]
            res = [f.result(timeout=600) for f in futs]
            b = c.metrics()["buckets"]["solve/N4096/float64"]
        poisoned = [i for i, g in enumerate(res)
                    if g.diagnostics and g.diagnostics.get("escalations")]
        if len(poisoned) != 1 or b["flushes"] != 1:
            raise AssertionError(f"serve chaos (poisoned member): "
                                 f"escalated {poisoned}, {b}")
        i = poisoned[0]
        configure_faults([FaultSpec(site="plan.output", kind="nan",
                                    times=(0,), lane=0, width=1)])
        want = execute_request(probs[i])
        reset_faults()
        if not (torch.equal(res[i].eigenvalues, want.eigenvalues)
                and res[i].diagnostics == want.diagnostics):
            raise AssertionError("serve chaos (poisoned member): the served "
                                 "escalation differs from the sync one")
        for j, (g, r) in enumerate(zip(res, refs[:4])):
            if j != i and not torch.equal(g.eigenvalues, r.eigenvalues):
                raise AssertionError("serve chaos (poisoned member): a "
                                     "flushmate changed")
        print(f"[8 chaos] plan.output-poisoned member {i} of a 4-request "
              f"flush escalated as its sync solve does "
              f"({res[i].diagnostics['escalations']}), its 3 flushmates "
              f"bit for bit")

        # times: 64 x 4096 problems three ways
        D = np.stack([d for d, _ in singles])
        E = np.stack([e for _, e in singles])
        singles_req = [("single", SolveRequest(d=d, e=e)) for d, e in singles]
        ways = {}
        with EigensolverClient(max_batch=64, max_wait_us=5000) as c:
            walls, spans, reps = [], [], []
            for rep in range(4):
                mark = len(c.engine.flush_log)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                futs = burst(c, singles_req)
                t_sub = time.perf_counter()
                for f in futs:
                    f.result(timeout=600)
                walls.append(time.perf_counter() - t0)
                # A future resolves at demux; its flush is logged just
                # after: wait for the burst's 64 problems.
                while sum(f["problems"] for f in
                          list(c.engine.flush_log)[mark:]) < 64:
                    time.sleep(0.001)
                log = list(c.engine.flush_log)[mark:]
                spans.append(sum(f["device_ms"] for f in log))
                reps.append((walls[-1], t_sub - t0,
                             min(f["launch_t"][0] for f in log) - t0,
                             [f["problems"] for f in log]))
            served_log = log
        for rep, (wall, sub, first, sizes) in enumerate(reps):
            print(f"[8 time] served burst {rep}{' (warm-up)' if not rep else ''}"
                  f": wall {wall * 1e3:.1f} ms; the 16 threads had "
                  f"submitted all 64 at {sub * 1e3:.1f} ms; first launch "
                  f"at {first * 1e3:.1f} ms; flushes of {sizes} problems")
        ways["served, 64 concurrent requests"] = (walls[1:], spans[1:])
        for label, fn in (
                ("one eigvalsh_tridiagonal_batch call",
                 lambda: eigvalsh_tridiagonal_batch(D, E)),
                ("sync loop of 64 eigvalsh_tridiagonal calls",
                 lambda: [eigvalsh_tridiagonal(d, e) for d, e in singles])):
            walls, spans = [], []
            fn()
            for rep in range(3):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                end.synchronize()
                walls.append(time.perf_counter() - t0)
                spans.append(start.elapsed_time(end))
            ways[label] = (walls, spans)
        for label, (walls, spans) in ways.items():
            w = statistics.median(walls)
            print(f"[8 time] 64 x n=4096 f64 (half uniform, half glued "
                  f"Wilkinson), {label}: {64 / w:.1f} problems/s (wall "
                  f"{w * 1e3:.1f} ms, median of {len(walls)}; stream span "
                  f"{statistics.median(spans):.1f} ms by CUDA events; "
                  f"{smi})")
        for f in served_log:
            a, b = f["launch_t"]
            leaf = sum(min(t1, b) - max(t0, a) for t0, t1 in leaf_spans
                       if t1 > a and t0 < b)
            print(f"[8 flush] {f['bucket']}: {f['requests']} requests, "
                  f"{f['problems']} problems; flush wall "
                  f"{f['wall_s'] * 1e3:.1f} ms, host in the launch "
                  f"{f['launch_s'] * 1e3:.1f} ms (of it in the leaf's "
                  f"torch.linalg.eigh {leaf * 1e3:.1f} ms), demux "
                  f"{f['demux_s'] * 1e3:.1f} ms, stream span "
                  f"{f['device_ms']:.1f} ms ({smi})")
        per = {}
        for f in flushes:
            a, b = f["launch_t"]
            leaf = sum(min(t1, b) - max(t0, a) for t0, t1 in leaf_spans
                       if t1 > a and t0 < b)
            per.setdefault(f["bucket"], []).append(
                (f["wall_s"] * 1e3, f["launch_s"] * 1e3, leaf * 1e3,
                 f["demux_s"] * 1e3, f["device_ms"]))
        for label, rows in sorted(per.items()):
            med = [statistics.median(col) for col in zip(*rows)]
            print(f"[8 flush] traffic bucket {label}: {len(rows)} flushes, "
                  f"median flush wall {med[0]:.1f} ms, host in the launch "
                  f"{med[1]:.1f} ms, in the leaf's eigh {med[2]:.1f} ms, "
                  f"demux {med[3]:.1f} ms, stream span {med[4]:.1f} ms "
                  f"({smi})")
    finally:
        reset_faults()
        br_dc._leaf_eigh = real_leaf
    print(f"[8 serve] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _mlp(torch, dev, seed=2021):
    """A float32 tanh MLP with 2^24 weights (1024 -> 2048 x 4 -> 1024) and
    a fixed synthetic regression batch (256 samples), all made on the card
    from ``seed``.  Returns (params, loss of params)."""
    sizes = (1024, 2048, 2048, 2048, 2048, 1024)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn(a, b, generator=gen,
                                      device=dev) / math.sqrt(a)
        params[f"b{i}"] = torch.zeros(b, device=dev)
    X = torch.randn(256, sizes[0], generator=gen, device=dev)
    Y = torch.randn(256, sizes[-1], generator=gen, device=dev)

    def loss(p):
        h = X
        for i in range(len(sizes) - 1):
            h = h @ p[f"w{i}"] + p[f"b{i}"]
            if i < len(sizes) - 2:
                h = torch.tanh(h)
        return torch.mean((h - Y) ** 2)

    return params, loss


def _phase9(torch, np, smi, Du, Eu, refs):
    """Phase 9: the tuner and the route-time consult, SLQ, sharpness and
    the spectral governor on the card (see the module docstring).  Raises
    on any failed check; returns the phase's launch counts by kernel
    name."""
    import tempfile

    import scipy.linalg as sla

    from repro_torch.core import eigvalsh_tridiagonal_batch, plan_cache_stats
    from repro_torch.core import plan as tplan
    from repro_torch.core import tune as ttune
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.optim import SpectralGovernor, adamw
    from repro_torch.serve import EigensolverClient
    from repro_torch.spectral import (lanczos_tridiag_batch, make_hvp,
                                      sharpness, slq_spectrum)
    from repro_torch.spectral import slq as tslq
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", 0)
    eps = float(np.finfo(np.float64).eps)
    kernels = {"resident_merge": resident_merge_cuda,
               "secular_roots": secular_solve_cuda,
               "fused_update": secular_postpass_cuda,
               "deflate_chain": deflate_chain_cuda,
               "sturm_count": sturm_count_cuda,
               "sturm_count_newton": sturm_count_newton_cuda,
               "sturm_bisect_tree": sturm_bisect_tree_cuda}
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0

    # ---- (a) the tuner, then the route-time consult ---------------------
    env = ttune.TUNE_CACHE_ENV
    old = os.environ.get(env)
    tmp = tempfile.mkdtemp(prefix="repro-torch-tune-")
    os.environ[env] = tmp
    tplan.clear_plan_cache()
    try:
        lines = []
        spec = [{"kind": "solve", "n": 4096, "batch": 64},
                {"kind": "range", "n": 16384, "k": 64},
                {"kind": "serve", "n": 4096, "requests": 64, "threads": 16}]
        report = tplan.tune(spec, iters=3, device=dev, log=lines.append)
        for line in lines:
            print(f"[9 tune] {line} ({smi})")
        for coord, ent in sorted(report["entries"].items()):
            print(f"[9 tune] {coord}: winner {ent['knobs']}, baseline "
                  f"{ent['baseline_us']} us, tuned {ent['tuned_us']} us "
                  f"(ratio {ent['ratio']}; host wall, best of 3) ({smi})")
        print(f"[9 tune] tune_workload of {len(spec)} workloads took "
              f"{report['seconds']:.1f} s; cache file "
              f"{os.path.basename(report['path'])}")
        with open(report["path"]) as f:
            payload = json.load(f)
        if payload["fingerprint"] != ttune.fingerprint(dev) or any(
                ent["ratio"] < 1.0 for ent in payload["entries"].values()):
            raise AssertionError(f"tune: bad cache file {payload}")

        tplan.clear_plan_cache()     # a fresh consult, from the file
        route = tplan.resolve_solve_route(4096, device=dev)
        N0 = tplan.resolve_solve_route(4096, leaf=tplan.LEAF_DEFAULT,
                                       device=dev).padded_n
        leaf = ttune.lookup("solve", n=N0, dtype="float64", device=dev)
        tree = ttune.lookup("solve", n=route.padded_n, dtype="float64",
                            device=dev)
        raced = set()
        for coord, ent in payload["entries"].items():
            if coord.startswith("solve|"):
                raced |= set(ent["knobs"])
        if (route.leaf != leaf["leaf"] or route.resident_threshold
                != tree["resident_threshold"]
                or raced != {"leaf", "resident_threshold"}):
            raise AssertionError(f"tune: the route {route} does not carry "
                                 f"the winners {leaf}, {tree}, or the card's "
                                 f"entries hold knobs it does not race "
                                 f"({raced})")
        explicit = dict(leaf=route.leaf,
                        stream_threshold=route.stream_threshold,
                        deflate_budget=route.deflate_budget,
                        resident_threshold=route.resident_threshold)
        lam_t = eigvalsh_tridiagonal_batch(Du, Eu).eigenvalues
        lam_e = eigvalsh_tridiagonal_batch(Du, Eu, **explicit).eigenvalues
        if not (lam_t.is_cuda and torch.equal(lam_t, lam_e)):
            raise AssertionError("tune: the tuned batch differs from the "
                                 "explicit one")
        lam = lam_t.cpu().numpy()
        worst = max(float(np.abs(lam[b] - refs[("uniform", b)][0]).max())
                    / refs[("uniform", b)][1] for b in range(len(lam)))
        if worst > 64:
            raise AssertionError(f"tune: the tuned B=64 x 4096 spectrum is "
                                 f"{worst:.2f} eps*||T||_inf off (bar 64)")
        stats = plan_cache_stats()
        if stats["tuned_routes"] < 1:
            raise AssertionError(f"tune: no tuned route {stats}")
        range_knobs = tplan.resolve_range_route(16384, 64, device=dev)
        print(f"[9 tune] fresh consult: resolve_solve_route(4096) leaf "
              f"{route.leaf}, resident_threshold "
              f"{route.resident_threshold}; range n=16384 k=64 maxiter "
              f"{range_knobs.maxiter}, polish {range_knobs.polish}; the "
              f"tuned B=64 x 4096 batch == the explicit one bit for bit, "
              f"{worst:.2f} eps*||T||_inf from the phase-3 reference (bar "
              f"64); tuned_routes {stats['tuned_routes']}, default_routes "
              f"{stats['default_routes']}")
    finally:
        if old is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old
        ttune.reload_tuning_cache()
        tplan.clear_plan_cache()

    # ---- (b) SLQ on the Hessian of a 2^24-weight MLP ---------------------
    params, loss = _mlp(torch, dev)
    dim = sum(x.numel() for x in tree_leaves(params))
    hvp = make_hvp(loss, params)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (alpha, beta), lanczos_s = timed(lambda: lanczos_tridiag_batch(
        hvp, tslq._probes(gen(90), params, 4), 64))
    peak = torch.cuda.max_memory_allocated(dev)
    direct, direct_s = timed(lambda: slq_spectrum(
        hvp, params, gen(90), num_probes=4, num_steps=64, leaf=8))
    with EigensolverClient(max_wait_us=1000) as client:
        served, served_s = timed(lambda: slq_spectrum(
            hvp, params, gen(90), num_probes=4, num_steps=64, leaf=8,
            client=client))
        sharp_s, sharp_served_s = timed(lambda: sharpness(
            hvp, params, gen(91), num_steps=16, client=client))
    sharp_d, sharp_direct_s = timed(lambda: sharpness(
        hvp, params, gen(91), num_steps=16))
    again, solve_s = timed(lambda: tslq._estimate(alpha, beta, dim, leaf=8))
    for name, est in (("served", served), ("from the phase's Lanczos",
                                            again)):
        if not (np.array_equal(est.nodes, direct.nodes)
                and np.array_equal(est.weights, direct.weights)
                and est.trace_est == direct.trace_est):
            raise AssertionError(f"slq: the {name} estimate differs from "
                                 f"the direct one")
    if sharp_s != sharp_d or not math.isfinite(sharp_s):
        raise AssertionError(f"sharpness: served {sharp_s!r} != direct "
                             f"{sharp_d!r}")
    a64 = alpha.double().cpu().numpy()
    b64 = beta.double().cpu().numpy()
    worst = 0.0
    for p in range(4):
        ref = sla.eigh_tridiagonal(a64[p], b64[p], eigvals_only=True,
                                   lapack_driver="stebz")
        worst = max(worst, float(np.abs(direct.nodes[p] - ref).max())
                    / (eps * max(1.0, _tinf(a64[p], b64[p]))))
    wsum = float(np.abs(direct.weights.sum(axis=1) - 1.0).max())
    if worst > 64 or wsum > 1e-12 or not np.isfinite(direct.nodes).all():
        raise AssertionError(f"slq: nodes {worst:.2f} eps*||T||_inf from "
                             f"stebz (bar 64), weight sums off 1 by {wsum}")
    print(f"[9 slq] Hessian of a tanh MLP, {dim} float32 weights, 4 "
          f"probes x m=64, leaf 8: Lanczos {lanczos_s:.2f} s (the first, "
          f"peak device memory {peak / 2**30:.1f} GiB), the solve of its 4 "
          f"tridiagonals {solve_s * 1e3:.1f} ms; slq_spectrum direct "
          f"{direct_s:.2f} s, served {served_s:.2f} s (kind='slq'), equal "
          f"bit for bit; nodes {worst:.2f} eps*||T||_inf from stebz (bar "
          f"64); weight sums off 1 by {wsum:.1e} (bar 1e-12); lam_max "
          f"{direct.lam_max:.6g}, lam_min {direct.lam_min:.6g}, trace_est "
          f"{direct.trace_est:.6g} ({smi})")
    print(f"[9 slq] sharpness (m=16): direct {sharp_direct_s * 1e3:.1f} ms, "
          f"served {sharp_served_s * 1e3:.1f} ms (kind='edges'), both "
          f"{sharp_d:.6g} bit for bit ({smi})")
    del alpha, beta

    # ---- (c) a known spectrum ---------------------------------------------
    n_c = 1 << 24
    spec_c = torch.empty(n_c, device=dev).uniform_(0.1, 1.0,
                                                   generator=gen(92))
    spec_c[n_c // 3], spec_c[n_c - 777] = -0.5, 2.0
    diag = {"a": spec_c[: n_c // 4].reshape(2048, -1),
            "b": spec_c[n_c // 4:]}
    like = tree_map(torch.zeros_like, diag)
    known, known_s = timed(lambda: slq_spectrum(
        lambda v: tree_map(lambda d, x: d * x, diag, v), like, gen(93),
        num_probes=4, num_steps=32, leaf=8))
    trace = float(spec_c.double().sum())
    inside = 64 * float(np.finfo(np.float32).eps) * 2.0
    rel = abs(known.trace_est - trace) / abs(trace)
    if not (-0.5 - inside <= known.lam_min <= -0.5 + 1e-4
            and 2.0 - 1e-4 <= known.lam_max <= 2.0 + inside
            and rel <= 1e-5):
        raise AssertionError(f"slq known spectrum: lam_min "
                             f"{known.lam_min!r}, lam_max {known.lam_max!r}"
                             f", trace_est {known.trace_est!r} vs {trace!r}")
    print(f"[9 slq] diagonal operator, {n_c} eigenvalues in [0.1, 1] plus "
          f"-0.5 and 2.0, 4 probes x m=32: lam_min {known.lam_min:.7f}, "
          f"lam_max {known.lam_max:.7f} (bar 1e-4), trace_est relative "
          f"error {rel:.2e} (bar 1e-5); {known_s:.2f} s ({smi})")
    del diag, like, spec_c

    # ---- (d) 20 adamw steps governed by served probes --------------------
    # The target lies below this MLP's lam_max (about 0.088 in (b)), so
    # the governor damps every step: scale = target / lam_max is about 0.57,
    # between min_scale and 1, and each probe's scale is checked against it.
    target = 0.05
    opt = adamw(lr=1e-4, weight_decay=0.0)
    state = opt.init(params)
    grad = torch.func.grad(loss)
    g_served = SpectralGovernor(target_sharpness=target, period=5)
    g_direct = SpectralGovernor(target_sharpness=target, period=5)
    probe_gen = gen(94)
    losses, probe_lams, probe_scales, probe_s = [], [], [], []
    step_ratio = None
    with EigensolverClient(max_wait_us=1000) as client:
        t0 = time.perf_counter()
        for step in range(20):
            if g_served.should_probe(step):
                hvp_at = make_hvp(loss, params)
                saved = probe_gen.get_state()
                t1 = time.perf_counter()
                g_served.probe(hvp_at, params, probe_gen, num_steps=16,
                               client=client)
                probe_s.append(time.perf_counter() - t1)
                probe_gen.set_state(saved)
                g_direct.probe(hvp_at, params, probe_gen, num_steps=16)
                if (g_served.lam_max != g_direct.lam_max
                        or g_served.scale != g_direct.scale):
                    raise AssertionError(
                        f"governor step {step}: served probe "
                        f"{g_served.lam_max!r} != direct "
                        f"{g_direct.lam_max!r}")
                want = max(g_served.min_scale,
                           min(1.0, target / g_served.lam_max))
                if not (g_served.scale == want
                        and g_served.min_scale < g_served.scale < 1.0):
                    raise AssertionError(
                        f"governor step {step}: lr_scale "
                        f"{g_served.scale!r}, expected {want!r} strictly "
                        f"between min_scale and 1 (lam_max "
                        f"{g_served.lam_max!r}, target {target})")
                probe_lams.append(g_served.lam_max)
                probe_scales.append(g_served.scale)
            losses.append(float(loss(params)))
            g = grad(params)
            new_params, new_state = opt.apply(params, g, state,
                                              lr_scale=g_served.scale)
            if step_ratio is None:
                # The update takes the scale: the governed step is the
                # ungoverned one times lr_scale (float32 rounding aside).
                free, _ = opt.apply(params, g, state, lr_scale=1.0)
                num = sum(float(((a - p).double() ** 2).sum()) for a, p in
                          zip(tree_leaves(new_params), tree_leaves(params)))
                den = sum(float(((a - p).double() ** 2).sum()) for a, p in
                          zip(tree_leaves(free), tree_leaves(params)))
                step_ratio = math.sqrt(num / den)
                if abs(step_ratio / g_served.scale - 1.0) > 1e-3:
                    raise AssertionError(
                        f"governed adamw step: update norm ratio "
                        f"{step_ratio!r} vs lr_scale {g_served.scale!r}")
                del free
            params, state = new_params, new_state
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    final = float(loss(params))
    if not (final < losses[0] and all(math.isfinite(x) for x in losses)
            and math.isfinite(g_served.lam_max)):
        raise AssertionError(f"governed adamw: loss {losses[0]} -> "
                             f"{final}, lam_max {g_served.lam_max!r}")
    print(f"[9 train] 20 adamw steps (lr 1e-4) on the MLP, lr_scale from "
          f"the governor: loss {losses[0]:.5f} -> {final:.5f}; {len(probe_s)}"
          f" served probes (m=16) at steps 0, 5, 10, 15, each == its direct "
          f"probe bit for bit: lam_max (EMA) {[f'{x:.5g}' for x in probe_lams]}"
          f", target {target}, lr_scale "
          f"{[f'{x:.5g}' for x in probe_scales]} (each max(min_scale, "
          f"target / lam_max)); step 0's update / the ungoverned update "
          f"{step_ratio:.6f}; probe wall "
          f"{[round(x * 1e3, 1) for x in probe_s]} ms; 20 steps with probes "
          f"{train_s:.2f} s ({smi})")

    # ---- (e) counts --------------------------------------------------------
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"[9 counts] launches in phase 9: {launches}")
    # The tuner's candidates below K = 2048 run the root solve and the
    # post-pass; SLQ the resident merge; edges, sharpness and the range
    # tuning the bisection tree and Newton.
    for name in ("resident_merge", "secular_roots", "fused_update",
                 "deflate_chain", "sturm_bisect_tree", "sturm_count_newton"):
        if launches[name] == 0:
            raise AssertionError(f"phase 9: {name} never launched")
    print(f"[9 time] phase 9 took {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import sass

    from repro_torch.core import (FAMILIES, SOLVE_COUNTER, SolveRequest,
                                  eigvalsh_tridiagonal,
                                  eigvalsh_tridiagonal_batch,
                                  eigvalsh_tridiagonal_br,
                                  eigvalsh_tridiagonal_range,
                                  execute_request, make_family,
                                  make_family_batch)
    from repro_torch.core import baselines as bl
    from repro_torch.core import bisect as bis
    from repro_torch.core import merge as mrg
    from repro_torch.core import secular as sec
    from repro_torch.core import sterf as qlmod
    from repro_torch.core import tune
    from repro_torch.core.br_dc import workspace_model
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import boundary_update as bmod
    from repro_torch.kernels import deflate_chain as dck
    from repro_torch.kernels import sterf as qlk
    from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels import resident_merge as rmod
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sterf import sterf_cuda
    from repro_torch.kernels.sturm_count import (chain_probe_cuda,
                                                 sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.kernels.zhat import zhat_reconstruct_cuda

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    # ---- phase 1: device and build --------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all(_build.SOURCES)
    build_s = time.perf_counter() - t0
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1 ptxas] {name}: {line.strip()}")

    # ---- phase 2: every kernel against its plain version ----------------
    # The row inputs R come from torch's generator: seeded, so a reading
    # repeats from run to run.
    torch.manual_seed(0)

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

    def excess(a, b, atol, rtol):
        """max |a - b|, and whether both are finite everywhere and within
        atol + rtol |b|.  A NaN fails: the float32 weights of the
        seed-2050 resident problem, once NaN where two poles coincide in
        float32, are finite since the repair of ROADMAP Queue 3 item 2."""
        diff = (a - b).abs()
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        return float(diff.max()), finite and bool(
            (diff <= atol + rtol * b.abs()).all())

    record = {}

    # The redesigned merge kernels' launch design: team size T, cluster
    # size C and CTA size at each resident level of the n = 16384 solve
    # (r = 2), of the B = 64 x 4096 batch and at the kernel table's shape
    # (B = 64, r = 3, K = 2048), with cudaOccupancyMaxActiveClusters; and
    # registers and spills from ptxas.
    sms = rmod.sm_count(0)
    design = {}
    for name, kern in (("secular_roots", "secular_roots_kernel"),
                       ("resident_merge", "resident_merge_kernel")):
        log = (_build.build_dir() / f"{name}.log").read_text()
        design[name] = {tag: _regs(log, f"{kern}I{code}E")
                        for tag, code in (("float64", "d"), ("float32", "f"))}
    regs_txt = {name: "; ".join(f"{tag} {v[0]} registers, spill stores "
                                f"{v[1]} B, loads {v[2]} B"
                                for tag, v in d_.items())
                for name, d_ in design.items()}
    print(f"[2 design] secular_roots: team T={rmod.TEAM} lanes per root "
          f"(secular_common.cuh, shared with the resident merge), no "
          f"cluster (C=1); {regs_txt['secular_roots']}")
    sizes = (64, 128, 256, 512, 1024, 2048)
    for label, r, levels in (
            ("n=16384 solve", 2, [(K, 16384 // K) for K in sizes]),
            ("B=64 x 4096 batch", 2, [(K, 64 * 4096 // K) for K in sizes]),
            ("table shape", 3, [(2048, 64)])):
        parts = []
        for K, lanes in levels:
            shp = rmod.launch_shape(lanes, K, r, torch.float64, sms)
            mac = rmod.max_active_clusters(0, torch.float64, r, K, shp)
            parts.append(f"K={K} x{lanes} lanes: C={shp.cluster}, "
                         f"{shp.threads} threads, {shp.smem} B shared, "
                         f"{mac} clusters at once")
        print(f"[2 design] resident_merge {label} (r={r}, f64; team "
              f"T={rmod.TEAM}, {sms} SMs): " + "; ".join(parts))
    design["resident_shape"] = (shp, mac)      # the table shape's, last
    print(f"[2 design] resident_merge: {regs_txt['resident_merge']}")
    # The weight kernel (zhat.cu, and pass A of fused_update.cu, both from
    # weights.cuh) and the post-pass's pass B: team, block and tile, and
    # registers and spills from ptxas.
    csrc = os.path.join(HERE, "src", "repro_torch", "csrc")
    wdesign = _constants(os.path.join(csrc, "weights.cuh"),
                         ("WEIGHT_THREADS", "WEIGHT_TILE"))
    rdesign = _constants(os.path.join(csrc, "fused_update.cu"),
                         ("ROWS_THREADS", "ROWS_TILE", "MAX_R"))
    for name, kern in (("zhat", "weights_kernel"),
                       ("fused_update", "rows_kernel")):
        log = (_build.build_dir() / f"{name}.log").read_text()
        design[name] = {tag: _regs(log, f"{kern}I{code}E")
                        for tag, code in (("float64", "d"), ("float32", "f"))}
    wregs = "; ".join(f"{tag} {v[0]} registers, spill stores {v[1]} B, "
                      f"loads {v[2]} B" for tag, v in design["zhat"].items())
    rregs = "; ".join(f"{tag} {v[0]} registers, spill stores {v[1]} B, "
                      f"loads {v[2]} B"
                      for tag, v in design["fused_update"].items())
    print(f"[2 design] zhat (weights.cuh, also the fused post-pass's pass "
          f"A): team T={rmod.TEAM} lanes per pole, "
          f"{wdesign['WEIGHT_THREADS']}-thread blocks "
          f"({wdesign['WEIGHT_THREADS'] // rmod.TEAM} poles of one lane), "
          f"the roots' d[origin], tau and d in two shared-memory tiles of "
          f"{wdesign['WEIGHT_TILE']} (double-buffered); weights_kernel "
          f"{wregs}")
    print(f"[2 design] fused_update pass B: team T={rmod.TEAM} lanes per "
          f"root column, {rdesign['ROWS_THREADS']}-thread blocks "
          f"({rdesign['ROWS_THREADS'] // rmod.TEAM} columns of one lane), "
          f"the poles' d, zhat and r <= {rdesign['MAX_R']} rows in two "
          f"shared-memory tiles of {rdesign['ROWS_TILE']} "
          f"(double-buffered); rows_kernel {rregs}")

    def report(name, dtype, shape, err, ok, k_ms, p_ms, extra=""):
        tag = str(dtype).replace("torch.", "")
        print(f"[2 kernel] {name} {tag} {shape}: max_abs_err {err:.3e} "
              f"kernel {k_ms:.3f} ms plain {p_ms:.3f} ms{extra}")
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
        # fused post-pass: the kernel table's shape (r = 2, 3), then the
        # levels the main path gives it above the resident threshold of an
        # n = 16384 solve (r = 2: 4 lanes at K = 4096 with a kprime that is
        # not a multiple of the team, 2 at K = 8192 with none deflated)
        for B, r, K, kp in ((8, 2, 2048, 1536), (8, 3, 2048, 1536),
                            (4, 2, 4096, 3581), (2, 2, 8192, 8192)):
            seed = r if K == 2048 else K + kp
            d, z, rho, kpr = problem(B, K, kp, seed=seed, dtype=dtype)
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
            if (K, r, tag) == (2048, 3, "float64"):
                kps = kpr.cpu().numpy()
                nbytes = ((2 * r + 4) * 8 + 4) * B * K + 12 * B
                record["fused_update"] = dict(
                    max_abs_err=max(e1, e2), ms=k_ms, plain_ms=p_ms,
                    flops=_postpass_ops(kps, r), nbytes=nbytes, dtype=tag,
                    pairs=float((kps.astype("float64") ** 2).sum()))
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
        # Two-pass conquer kernels (fused=False and the r = K baselines):
        # the log-space weights and the any-row update at the shapes the
        # path gives them -- r = 3 rows at K = 4096 (B = 4) and 8192
        # (B = 2), the top levels of an n = 16384 fused=False solve, and
        # r = K rows at K = 2048 and 4096 (B = 1), the top levels of an
        # n = 4096 full-vector solve -- and r = 5 at K = 4096, the fewest
        # rows of the tile path.  An r > 4 output entry is a K-term dot
        # product of a row of R with a unit column of Y: it is held to
        # atol + 2 sqrt(K) eps ||R[b, i, :]||, and a zeroed and a
        # sign-flipped output must fail that bar.  Yardstick: torch.matmul
        # of the pre-formed normalized Y (the product only, never the
        # port).
        two_pass_shapes = ((4, 4096, 3), (2, 8192, 3), (1, 4096, 5),
                           (1, 2048, 2048), (1, 4096, 4096))
        print(f"[2 design] boundary_update {tag}: " + "; ".join(
            f"B={B} r={r} K={K}: {bmod.launch_shape(B, r, K, dtype)}"
            for B, K, r in two_pass_shapes))
        for B, K, r in two_pass_shapes:
            kp = (7 * K) // 8
            d, z, rho, kpr = problem(B, K, kp, seed=K + r + 7, dtype=dtype)
            o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=niter)
            run_k = lambda: zhat_reconstruct_cuda(  # noqa: E731
                d, z, o, t, kpr, rho)
            run_p = lambda: sec.zhat_reconstruct_batched(  # noqa: E731
                d, z, o, t, kpr, rho, chunk=256)
            w, wp = run_k(), run_p()
            ez, okz = excess(w, wp, atol, rtol)
            zk_ms, zp_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
            kps = kpr.cpu().numpy()
            if r == 3:
                report("zhat", dtype, (B, K, kp), ez, okz, zk_ms, zp_ms)
                if tag == "float64":
                    record[("zhat", K)] = dict(
                        max_abs_err=ez, ms=zk_ms, plain_ms=zp_ms, B=B, K=K,
                        kp=kp, flops=_zhat_ops(kps),
                        pairs=_zhat_ops(kps) / 5,
                        nbytes=(4 * 8 + 4) * B * K + 12 * B)
            R = torch.randn(B, r, K, dtype=dtype, device=dev)
            run_k = lambda: boundary_rows_update_cuda(  # noqa: E731
                R, d, w, o, t, kpr)
            run_p = lambda: sec.boundary_rows_update_batched(  # noqa: E731
                R, d, w, o, t, kpr, chunk=256)
            got, want = run_k(), run_p()
            extra = ""
            if r > 4:
                bar = atol + (2 * math.sqrt(K) * float(torch.finfo(
                    dtype).eps)) * R.norm(dim=2, keepdim=True)
                eb, okb = excess(got, want, bar, 0.0)
                e0, ok0 = excess(torch.zeros_like(got), want, bar, 0.0)
                ef, okf = excess(-got, want, bar, 0.0)
                okb = okb and not ok0 and not okf
                extra = (f"; bar atol + 2 sqrt(K) eps ||R row|| <= "
                         f"{float(bar.max()):.3e}, a zeroed output "
                         f"{e0:.3e} and a sign-flipped one {ef:.3e} "
                         f"{'fail' if not (ok0 or okf) else 'PASS'} it")
            else:
                eb, okb = excess(got, want, atol, rtol)
            del got, want
            bk_ms, bp_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
            Y = _dense_y(torch, d, w, o, t, kpr)
            lib_ms = _cuda_ms(torch, lambda: torch.matmul(R, Y))
            del Y
            report("boundary_update", dtype, (B, r, K, kp), eb, okb, bk_ms,
                   bp_ms, f"; torch.matmul of a pre-formed Y (product "
                   f"only) {lib_ms:.3f} ms{extra}")
            if tag == "float64":
                record[("boundary", r, K)] = dict(
                    max_abs_err=eb, ms=bk_ms, plain_ms=bp_ms,
                    library_ms=lib_ms, B=B, K=K, kp=kp, r=r,
                    ops=_boundary_ops(kps, r),
                    nbytes=((2 * r + 3) * 8 + 4) * B * K + 4 * B)

        # zhat's largest lane: the root level of an n = 16384 lazy or
        # full-vector solve (one lane of K = 16384).
        B, K, kp = 1, 16384, 14336
        d, z, rho, kpr = problem(B, K, kp, seed=K + 3, dtype=dtype)
        o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=niter)
        run_k = lambda: zhat_reconstruct_cuda(  # noqa: E731
            d, z, o, t, kpr, rho)
        run_p = lambda: sec.zhat_reconstruct_batched(  # noqa: E731
            d, z, o, t, kpr, rho, chunk=256)
        ez, okz = excess(run_k(), run_p(), atol, rtol)
        zk_ms, zp_ms = _cuda_ms(torch, run_k), _cuda_ms(torch, run_p, 3)
        report("zhat", dtype, (B, K, kp), ez, okz, zk_ms, zp_ms)
        if tag == "float64":
            record[("zhat", K)] = dict(
                max_abs_err=ez, ms=zk_ms, plain_ms=zp_ms, B=B, K=K, kp=kp,
                flops=_zhat_ops(kpr.cpu().numpy()),
                pairs=_zhat_ops(kpr.cpu().numpy()) / 5,
                nbytes=(4 * 8 + 4) * B * K + 12 * B)

    # Library yardstick of kernel-table rows 1-2: torch.linalg.eigvalsh of
    # the pre-formed dense diag(d) + rho z z^T (formed before the clock),
    # on the inputs of the two table shapes above.  It computes the same
    # eigenvalues; for the resident merge the roots only (no zhat, no rows).
    for name, (B, K, kp, seed), note in (
            ("secular_roots", (1, 16384, 16384, 32768), ""),
            ("resident_merge", (64, 2048, 1536, 2051),
             " (roots only: no zhat, no rows)")):
        d, z, rho, kpr = problem(B, K, kp, seed=seed, dtype=torch.float64)
        A = (torch.diag_embed(d)
             + rho[:, None, None] * z[:, :, None] * z[:, None, :])
        lib_ms = _cuda_ms(torch, lambda: torch.linalg.eigvalsh(A), reps=3)
        lam_lib = torch.linalg.eigvalsh(A)
        del A
        o, t = secular_solve_cuda(d, z * z, rho, kpr, niter=16)
        lam_k = torch.sort(sec.secular_eigenvalues(d, o, t), dim=1).values
        gap = float((lam_k - lam_lib).abs().max())
        record[name].update(library_ms=lib_ms,
                            library="torch.linalg.eigvalsh of the pre-formed "
                                    "diag(d) + rho z z^T" + note)
        print(f"[2 library] {name} (B={B}, K={K}, kprime={kp}, float64): "
              f"torch.linalg.eigvalsh of the pre-formed diag(d) + rho z z^T"
              f"{note} {lib_ms:.3f} ms (median of 3) against the kernel's "
              f"{record[name]['ms']:.3f} ms; max |eigenvalue difference| "
              f"{gap:.3e} ({smi})")

    # QL kernel vs its plain loop on the CPU at n = 256, f64 and f32, held
    # at sterf's bar (64 eps ||T||_inf at this n): hypot differs between
    # math libraries by an ulp, which moves QL's trajectory by about the
    # algorithm's own error (the plain loop and repro's sterf differ by
    # 21 eps at n = 256 on the CPU).
    for dtype in (torch.float64, torch.float32):
        for fam in ("uniform", "glued_wilkinson"):
            d, e = make_family(fam, 256, seed=256)
            dh = torch.tensor(d, dtype=dtype)[None]
            eh = torch.tensor(e, dtype=dtype)[None]
            dd, ed = dh.to(dev), eh.to(dev)
            lam_k, steps_k = sterf_cuda(dd, ed)
            t0 = time.perf_counter()
            lam_p, steps_p = qlmod.sterf_plain(dh, eh)
            p_ms = (time.perf_counter() - t0) * 1e3
            err = float((lam_k.cpu() - lam_p).abs().max())
            bar = (_sterf_bar(256) * float(torch.finfo(dtype).eps)
                   * max(1.0, _tinf(d, e)))
            k_ms = _cuda_ms(torch, lambda: sterf_cuda(dd, ed))
            report("sterf", dtype, (fam, 256), err,
                   bool(torch.isfinite(lam_k).all()) and err <= bar, k_ms,
                   p_ms, f" (plain on the CPU); rotations kernel "
                   f"{int(steps_k[0])} plain {int(steps_p[0])}; bar "
                   f"{bar:.3e}")

    # The two redesigned kernels' builds: registers and spills (ptxas) of
    # each kernel function, the DMMA instructions of the row update's
    # tensor-core path (cuobjdump), and the QL kernel's launch shape.
    bu_log = (_build.build_dir() / "boundary_update.log").read_text()
    bu_regs = {}
    for tag, code in (("f64", "d"), ("f32", "f")):
        for nr in range(5):
            bu_regs[f"team r={nr} {tag}"] = _regs(
                bu_log, f"rows_team_kernelI{code}Li{nr}E")
        bu_regs[f"simt {tag}"] = _regs(bu_log, f"rows_tile_kernelI{code}E")
    bu_regs["mma f64"] = _regs(bu_log, "rows_mma_kernelE")
    dmma = sass.count(_build.build_dir() / "libboundary_update.so",
                       "rows_mma_kernel", "DMMA")
    print("[2 design] boundary_update registers, spill stores, spill loads "
          "(B): " + "; ".join(f"{k} {v[0]}, {v[1]}, {v[2]}"
                              for k, v in bu_regs.items())
          + f"; DMMA instructions in rows_mma_kernel's SASS: "
            f"{'not measured (no cuobjdump)' if dmma is None else dmma}")
    if dmma == 0:
        raise AssertionError("the row update's tensor-core path has no DMMA")
    ql_log = (_build.build_dir() / "sterf.log").read_text()
    ql_regs = {"sterf f64": _regs(ql_log, "sterf_kernelIdE"),
               "sterf f32": _regs(ql_log, "sterf_kernelIfE"),
               "chain probe": _regs(ql_log, "chain_probe_kernel")}
    print("[2 design] sterf: " + "; ".join(
        f"n={n}: {qlk.launch_shape(1, n, torch.float64)}"
        for n in (256, 4096, 16384)) + "; registers, spill stores, spill "
        "loads (B): " + "; ".join(f"{k} {v[0]}, {v[1]}, {v[2]}"
                                  for k, v in ql_regs.items()))

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
    newton_ms = trip["sturm_count_newton"]["ms"]
    print(f"[2 chain] one shift's chain on one thread (n=16384, f64): "
          f"{chain_ms:.4f} ms, {trip['chain_ns_row']:.2f} ns and "
          f"{cycles_row:.1f} SM cycles per row (SM clock over the sweep "
          f"about {int(c_cycles) / (chain_ms * 1e3):.0f} MHz); one count "
          f"sweep of S=64 {trip_ms:.4f} ms = {trip_ms / chain_ms:.3f}x this "
          f"chain bound, one Newton sweep {newton_ms:.4f} ms = "
          f"{newton_ms / chain_ms:.3f}x ({smi})")

    # The bisection tree: one launch walks ``depth`` halvings of every
    # bracket.  Held to its plain version bit for bit (lo, hi and every
    # node count) over the first three launches of a range solve's
    # brackets -- B = 1, n = 16384, k = 64 (the bottom 64), depth 8 -- and
    # of the edges probes' -- the B = 64 x 4096 uniform batch with its rows
    # duplicated (targets 0..7 and 4088..4095), k = 8, the depth the rule
    # gives 1024 brackets -- in float64 and float32; each launch's time
    # beside the chain probe (its latency bound).
    chains_c = tune.backend_defaults("cuda")["bisect_chains"]
    Dt, Et = batches["uniform"]
    tree_cases = {
        "range": (d16[None], e16[None], np.arange(64)[None], 8),
        "edges": (np.concatenate([Dt, Dt]), np.concatenate([Et, Et]),
                  np.concatenate([np.tile(np.arange(8), (64, 1)),
                                  np.tile(np.arange(4088, 4096), (64, 1))]),
                  tune.bisect_depth(128 * 8, chains_c))}
    for case, (D, E, tg, depth) in tree_cases.items():
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype).replace("torch.", "")
            d = torch.tensor(D, dtype=dtype, device=dev)
            e = torch.tensor(E, dtype=dtype, device=dev)
            e2 = e * e
            piv = bis._pivot_floor(e2)
            glo, ghi = bis._gershgorin(d, e.abs(), piv)
            tol = (2.0 * torch.finfo(dtype).eps
                   * torch.maximum(glo.abs(), ghi.abs()) + 2.0 * piv)
            targets = torch.tensor(tg, dtype=torch.int32, device=dev)
            B, k = targets.shape
            lo = glo.expand(B, k).contiguous()
            hi = ghi.expand(B, k).contiguous()
            run_k = lambda lo=lo, hi=hi: sturm_bisect_tree_cuda(  # noqa: E731
                d, e2, piv[:, 0], tol[:, 0], targets, lo, hi, depth=depth,
                steps=depth)
            run_p = lambda lo=lo, hi=hi: bis.bisect_tree_plain(  # noqa: E731
                d, e2, piv, tol, targets, lo, hi, depth=depth, steps=depth)
            k_ms = _cuda_ms(torch, run_k)
            p_ms = _cuda_ms(torch, run_p, 2)
            err = 0.0
            for trip_no in range(3):
                ka, pa = run_k(lo, hi), run_p(lo, hi)
                if trip_no == 0:           # the timed launch's halvings
                    halvings = _live_halvings(lo, hi, tol, targets, ka[2],
                                              depth)
                same = all(torch.equal(a, b) for a, b in zip(ka, pa))
                err = max(err, float((ka[0] - pa[0]).abs().max()),
                          float((ka[1] - pa[1]).abs().max()))
                if not same:
                    raise AssertionError(
                        f"sturm_bisect_tree {case} {tag} launch {trip_no}: "
                        f"lo, hi or node counts differ from the plain tree")
                lo, hi = ka[0], ka[1]
            print(f"[2 kernel] sturm_bisect_tree {tag} {case} (B={B}, "
                  f"n={d.shape[1]}, k={k}, depth={depth}): lo, hi and node "
                  f"counts equal the plain tree over 3 launches True; "
                  f"kernel {k_ms:.3f} ms plain {p_ms:.3f} ms")
            if tag == "float64":
                record[("tree", case)] = dict(
                    B=B, n=d.shape[1], k=k, depth=depth, ms=k_ms,
                    plain_ms=p_ms, max_abs_err=err, halvings=halvings)
    for case, r in ((c, record[("tree", c)]) for c in tree_cases):
        work_ms = _bound_ms(_sturm_ops(1, r["n"], r["halvings"], False),
                            _tree_bytes(r["B"], r["n"], r["k"]),
                            "float64")[0]
        print(f"[2 chain] sturm_bisect_tree {case} (B={r['B']}, n={r['n']}, "
              f"k={r['k']}, depth {r['depth']}: {r['depth']} halvings, "
              f"{r['k'] * (2 ** r['depth'] - 1) * r['B']} node chains): "
              f"{r['ms']:.4f} ms a launch = "
              f"{r['ms'] / (chain_ms * r['n'] / trip['n']):.3f}x the chain "
              f"probe's {r['n']} rows; bound of its {r['halvings']} live "
              f"halvings {work_ms:.6f} ms ({smi})")

    # Instruction figures of zhat, the post-pass and the Sturm counts at
    # the table's shapes: each kernel's hot loop, read from its SASS
    # (scripts/sass.py), gives its FP64-pipe instructions and all its
    # instructions per pair or row; times the pairs or rows, over the SMs'
    # FP64 lanes and issue slots at the SM clock of the chain probe above.
    # Both count the code as compiled, so they diagnose the loop (how near
    # it runs to its own issue rate) and do not bound the function: a loop
    # that issues more than it needs looks near them.  The function's
    # bound is the table's.  (A bisection trip is bound by its chain,
    # above, not by instructions.)
    sm_hz = int(c_cycles) / (chain_ms * 1e-3)

    def per_item(name, kernel, items=1):
        return sass.instructions_per_item(
            _build.build_dir() / f"lib{name}.so", kernel, items)
    counts = {
        "zhat": per_item("zhat", "weights_kernelIdE"),
        "pass A": per_item("fused_update", "weights_kernelIdE"),
        "pass B": per_item("fused_update", "rows_kernelIdE"),
        "sturm_count": per_item("sturm_count", "count_kernelIdLb0EE"),
        "sturm_count_newton": per_item("sturm_count",
                                       "count_kernelIdLb1EE", 2),
        "sturm_bisect_tree": per_item("sturm_count", "tree_kernelIdE")}
    pa, pb = counts["pass A"], counts["pass B"]
    counts["fused_update"] = ((pa[0] + pb[0], pa[1] + pb[1]) if pa and pb
                              else None)
    zr, fr = record[("zhat", 8192)], record["fused_update"]
    st = record[("sturm", 64)]
    sturm_rows = st["B"] * st["S"] * st["n"]
    table = {"zhat": (zr["pairs"], zr["ms"], "pair",
                      f"B={zr['B']} K={zr['K']} kprime={zr['kp']}"),
             "fused_update": (fr["pairs"], fr["ms"], "pair",
                              "B=8 r=3 K=2048 kprime=1536"),
             "sturm_count": (sturm_rows, st["sturm_count"]["ms"], "row",
                             f"B={st['B']} n={st['n']} S={st['S']}"),
             "sturm_count_newton": (sturm_rows,
                                    st["sturm_count_newton"]["ms"],
                                    "row",
                                    f"B={st['B']} n={st['n']} S={st['S']}")}
    te = record[("tree", "edges")]
    table["sturm_bisect_tree"] = (
        te["B"] * te["k"] * (2 ** te["depth"] - 1) * te["n"], te["ms"], "row",
        f"B={te['B']} n={te['n']} k={te['k']} depth={te['depth']}")
    instr_bounds = {name: _instr_bounds_ms(counts[name], items, sm_hz, sms)
                    for name, (items, *_) in table.items()}
    parts = []
    for name, (items, ms, unit, shape) in table.items():
        if counts[name] is None:
            parts.append(f"{name}: not measured (no cuobjdump)")
            continue
        fb, ib = instr_bounds[name]
        parts.append(f"{name} ({shape}): {counts[name][0]:.2f} FP64-pipe "
                     f"of {counts[name][1]:.2f} instructions per {unit}, "
                     f"FP64 bound {fb:.4f} ms, issue-slot time "
                     f"{ib:.4f} ms, kernel {ms:.4f} ms")
    print(f"[2 bound] hot loops read from the SASS, at the SM clock "
          f"{sm_hz / 1e6:.0f} MHz, {sms} SMs x 64 FP64 lanes and 128 issue "
          f"slots a cycle: " + "; ".join(parts) + f" ({smi})")
    # The depth rule's chain count: node chains whose issue time fits
    # under one chain's latency, from the tree loop's instructions a row.
    if counts["sturm_bisect_tree"]:
        fits = (sms * 128 * sm_hz * trip["chain_ns_row"] * 1e-9
                / counts["sturm_bisect_tree"][1])
        print(f"[2 bound] bisection tree: {fits:.0f} node chains issue "
              f"within one chain's latency ({trip['chain_ns_row']:.2f} ns "
              f"a row, {counts['sturm_bisect_tree'][1]:.2f} instructions a "
              f"row); tune.backend_defaults('cuda')['bisect_chains'] = "
              f"{chains_c} ({smi})")

    # QL's chain bound: the probe runs the kernel's rotation on one thread
    # with its rows in registers (the first PROBE_ROWS + 1 rows of phase
    # 7's n = 4096 uniform problem, 65536 passes), and the kernel's
    # rotations on that problem times the probe's time per rotation bound
    # the solve.
    dq = torch.tensor(batches["uniform"][0][0], device=dev)
    eq = torch.tensor(batches["uniform"][1][0], device=dev)
    _, q_steps = sterf_cuda(dq[None], eq[None])
    reps = 65536
    run_p = lambda: qlk.chain_probe_cuda(dq, eq, reps)  # noqa: E731
    _, _, p_rot, p_cyc, p_ok = run_p()
    probe_ms = _cuda_ms(torch, run_p, 3)
    if int(p_ok) != 1:
        raise AssertionError("the chain probe left the rsqrt range")
    ql_chain = dict(ns_per_rotation=probe_ms * 1e6 / int(p_rot),
                    cycles_per_rotation=int(p_cyc) / int(p_rot),
                    rotations=int(q_steps[0]))
    ql_chain["bound_ms"] = ql_chain["ns_per_rotation"] * int(q_steps[0]) / 1e6
    print(f"[2 chain] sterf: the rotation chain on one thread, rows in "
          f"registers: {ql_chain['ns_per_rotation']:.2f} ns and "
          f"{ql_chain['cycles_per_rotation']:.1f} SM cycles per rotation "
          f"({int(p_rot)} rotations); chain bound at n=4096 uniform "
          f"{int(q_steps[0])} rotations x that = {ql_chain['bound_ms']:.1f} "
          f"ms ({smi})")

    # The deflation chain (csrc/deflate_chain.cu) against the plain chain
    # run on the card (torch.hypot is CUDA's hypot there), bit for bit on
    # d, z, R and the mask, in float64 and float32, on real merge lanes:
    # the chain inputs of card solves, recorded by a spy on
    # merge._deflate_level -- the K = 2048 level of a B = 32 x 4000 batch
    # (W = 64; return_boundary=True on a padded n, so r = 3) and the
    # K = 16384 level of an n = 16000 solve (W = 1, r = 3), glued
    # Wilkinson and uniform; R = I on 8 lanes of the glued K = 512 level
    # (r = K = 512, the rows of the lazy and full baselines); and the edge
    # cases of tests/test_torch_deflate_chain.py; and the r = K = 2048
    # (W = 2) and r = K = 4096 (W = 1) levels of the glued n = 4096 lazy
    # solve (R as the solve gives it), which take the split route.  Timed
    # beside the plain chain and the parallel head the kernel replaced on
    # the card (merge._deflate_head: a candidate chain, a post-check, two
    # host syncs); one run each of those.
    def chain_inputs(fn):
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

    def same_bits(a, b):
        if a.dtype == torch.bool:
            return bool(torch.equal(a, b))
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        return bool(torch.equal(a.view(view), b.view(view)))

    edge_lanes = (
        ("missed rotation", [0, 0, 0.01, 0.02, 0.03, 1.0],
         [1, 0.01, 0.01, 0.01, 0.01, 0.01], [0] * 6, 1e-3),
        ("K=2", [1.0, 1.0], [0.6, 0.8], [0, 0], 1e-12),
        ("all poles small", np.linspace(0, 1, 40), np.zeros(40), [1] * 40,
         1e-3),
        ("small first pole", [0.5, 0.5, 0.5, 0.7], [0, 0.6, 0.8, 0.1],
         [1, 0, 0, 0], 1e-6),
        ("tau == 0 pair", [1.0, 1.0, 1.0, 2.0], [0, 0, 0.5, 0.5], [0] * 4,
         1e-6))
    chain_cases = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        cases = []
        for fam in ("glued_wilkinson", "uniform"):
            D, E = make_family_batch(fam, 4000, 32, seed0=400)
            lv = chain_inputs(lambda: eigvalsh_tridiagonal_batch(
                D, E, return_boundary=True, dtype=dtype))
            cases.append((f"{fam} W=64 r=3 K=2048", lv[2048]))
            if fam == "glued_wilkinson":
                d5, z5, _, s5, t5 = (x[:8] for x in lv[512])
                eye = torch.eye(512, dtype=dtype, device=dev).expand(
                    8, 512, 512).contiguous()
                r_is_k = (f"{fam} W=8 r=K=512", (d5, z5, eye, s5, t5))
            d1, e1 = make_family(fam, 16000, seed=16)
            lv = chain_inputs(lambda: eigvalsh_tridiagonal_br(
                d1, e1, return_boundary=True, dtype=dtype))
            cases.append((f"{fam} W=1 r=3 K=16384", lv[16384]))
        cases.append(r_is_k)
        Dg, Eg = batches["glued_wilkinson"]
        lz = chain_inputs(lambda: eigvalsh_tridiagonal(
            Dg[0], Eg[0], method="lazy", dtype=dtype))
        cases += [(f"glued_wilkinson lazy W={lz[K][0].shape[0]} r=K={K}",
                   lz[K]) for K in (2048, 4096)]
        for name, d, z, small, tol in edge_lanes:
            t = lambda a: torch.tensor(  # noqa: E731
                np.asarray([a], dtype=float), dtype=dtype, device=dev)
            cases.append((f"edge: {name}", (
                t(d), t(z), torch.randn(1, 3, len(d), dtype=dtype,
                                        device=dev),
                torch.tensor([small], dtype=torch.bool, device=dev),
                t(tol))))
        for label, args in cases:
            run_k = lambda: deflate_chain_cuda(*args)  # noqa: E731
            got = run_k()
            want, p_ms = _cuda_once(torch, lambda: mrg._close_pole_scan(
                *args))
            same = all(same_bits(a, b) for a, b in zip(got, want))
            err = max(float((a - b).abs().max()) for a, b in zip(got[:3],
                                                                 want[:3]))
            k_ms = _cuda_ms(torch, run_k)
            small_np = args[3].cpu().numpy()
            defl_np = got[3].cpu().numpy()
            rot = (defl_np & ~small_np).sum(axis=1)
            steps = _window_steps(small_np, defl_np)
            W, r, K = args[2].shape
            head = ""
            if not label.startswith("edge"):
                _, h_ms = _cuda_once(torch, lambda: mrg._deflate_head(
                    *args, budget=mrg.DEFAULT_DEFLATE_BUDGET))
                head = f" parallel head (replaced) {h_ms:.3f} ms"
            print(f"[2 kernel] deflate_chain {tag} {label} (route "
                  f"{dck.launch_shape(W, r, K, dtype).route}): bitwise {same} "
                  f"(max_abs_err {err:.3e}); kernel {k_ms:.3f} ms plain "
                  f"chain {p_ms:.3f} ms{head}; rotations of the longest "
                  f"lane {int(rot.max())}, of all {int(rot.sum())}; "
                  f"dependent steps of the longest lane {int(steps.max())} "
                  f"(K={K})")
            if not same:
                raise AssertionError(f"deflate_chain {tag} {label} differs "
                                     f"from the plain chain")
            if tag == "float64" and not label.startswith("edge"):
                chain_cases[label] = dict(
                    ms=k_ms, plain_ms=p_ms, head_ms=h_ms, max_abs_err=err,
                    steps=int(steps.max()), rotations=int(rot.max()),
                    nbytes=W * K * (4 * 8 + 2) + 2 * W * r * K * 8 + 8 * W,
                    shape=dck.launch_shape(W, r, K, dtype), args=args)

    # The chain's latency floor: one warp runs the kernel's window step
    # back to back on the first 32 poles of a glued lane, in registers;
    # the longest lane's dependent steps times that bound a level.
    d_, z_, _, s_, t_ = chain_cases["glued_wilkinson W=64 r=3 K=2048"]["args"]
    reps = 65536
    run_c = lambda: dck.chain_probe_cuda(  # noqa: E731
        d_[0], z_[0], s_[0], float(t_[0]), reps)
    c_cycles, c_fires = run_c()
    probe_ms = _cuda_ms(torch, run_c, 3)
    step_ns = probe_ms * 1e6 / reps
    step_cycles = int(c_cycles) / reps
    for rec in chain_cases.values():
        rec.pop("args")
        rec["chain_bound_ms"] = rec["steps"] * step_ns / 1e6
        rec["bytes_bound_ms"] = rec["nbytes"] / PEAK_BYTES * 1e3
        rec["bound"] = (max(rec["chain_bound_ms"], rec["bytes_bound_ms"]),
                        "operations" if rec["chain_bound_ms"]
                        >= rec["bytes_bound_ms"] else "bytes")
    dc_log = (_build.build_dir() / "deflate_chain.log").read_text()
    dc_regs = {fn: v for fn, v in _ptxas(dc_log).items()
               if "deflate_chain_kernel" in fn or "apply_rotations" in fn}
    print("[2 design] deflate_chain: route by r (fused below "
          f"dck.SPLIT_MIN_R = {dck.SPLIT_MIN_R} rows, split from it; "
          f"APPLY_TARGET {dck.APPLY_TARGET} threads, COPY_BLOCKS "
          f"{dck.COPY_BLOCKS}); " + "; ".join(
              f"{k}: {v['shape'].route} chain blocks "
              f"{v['shape'].chain_blocks} + copy blocks "
              f"{v['shape'].copy_blocks} x {v['shape'].threads}, apply "
              f"grid {v['shape'].apply_grid} x {v['shape'].apply_threads}"
              for k, v in chain_cases.items()) + "; registers, spill "
          "stores, spill loads: " + "; ".join(
              f"{fn} {v}" for fn, v in dc_regs.items()))
    print(f"[2 chain] deflate_chain: one window step on one warp, operands "
          f"in registers: {step_ns:.1f} ns and {step_cycles:.1f} SM cycles "
          f"({int(c_fires)} of {reps} steps rotated); chain bound = "
          f"dependent steps of the longest lane x that: " + "; ".join(
              f"{k} {v['steps']} steps, {v['chain_bound_ms']:.4f} ms "
              f"(bytes {v['bytes_bound_ms']:.4f} ms) against the kernel's "
              f"{v['ms']:.4f} ms" for k, v in chain_cases.items())
          + f" ({smi})")

    # ---- phase 3: the main path -----------------------------------------
    # scipy references run in worker processes while the card works;
    # they are collected before the timings of phase 5.
    eps = float(np.finfo(np.float64).eps)
    pool = ProcessPoolExecutor(max_workers=min(7, os.cpu_count() or 1),
                               mp_context=mp.get_context("spawn"))
    jobs = []
    src = os.path.join(HERE, "src")
    # The plain QL loop at phase 7's n = 4096 takes tens of seconds on the
    # CPU: it starts first.
    Du, Eu = batches["uniform"]
    plain_ql = pool.submit(_plain_sterf, src, Du[0], Eu[0])

    def check_later(key, label, d, e, lam):
        scale = eps * max(1.0, _tinf(d, e))
        jobs.append((key, label, d, lam, scale,
                     pool.submit(_reference, d, e, lam, 8 * scale)))

    kernels = (secular_solve_cuda, secular_postpass_cuda,
               resident_merge_cuda, deflate_chain_cuda)
    sturm_kernels = (sturm_count_cuda, sturm_count_newton_cuda,
                     sturm_bisect_tree_cuda)
    try:
        for k in kernels + sturm_kernels:
            k.launches = 0
        deflate_chain_cuda.apply_launches = 0
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
        apply_main = deflate_chain_cuda.apply_launches
        per_batch = [(a - b) / len(batches)
                     for a, b in zip(launches, per_solve)]
        print(f"[3 main] launches (secular_roots, fused_update, "
              f"resident_merge, deflate_chain): n=16384 solve {per_solve}, "
              f"B=64 x 4096 batch (mean of {len(batches)}) {per_batch}, "
              f"total {launches}")
        if min(launches) == 0:
            raise AssertionError(f"a kernel of the main path never "
                                 f"launched: {launches}")
        if per_solve[3] != 9 or per_batch[3] != 7:
            raise AssertionError(f"deflate_chain launched {per_solve[3]} "
                                 f"times per n=16384 solve (9 levels) and "
                                 f"{per_batch[3]} per batch (7 levels)")

        # ---- phase 4: invariants (the references keep running) ---------
        D, E = make_family_batch("uniform", 1000, 4, seed0=7)
        bat = eigvalsh_tridiagonal_batch(D, E).eigenvalues
        loop = torch.stack([eigvalsh_tridiagonal(D[b], E[b])
                            for b in range(4)])
        diff = float((bat - loop).abs().max())
        bar = 64 * eps * max(1.0, max(_tinf(D[b], E[b]) for b in range(4)))
        if diff > bar:
            raise AssertionError(f"batched vs looped differ by {diff:.3e}")
        bitwise = bool(torch.equal(bat, loop))
        print(f"[4 invariant] batched vs looped (4 x n=1000): max diff "
              f"{diff:.3e}, bitwise {bitwise}")
        if not bitwise:
            raise AssertionError("batched vs looped: not the same bits")
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
        print(f"[6 sturm] launches (sturm_count, sturm_count_newton, "
              f"sturm_bisect_tree): per n=16384 range solve (k=64) "
              f"{per_range}; per certify "
              f"sweep {per_cert}; phase total {sturm_launches}; merge "
              f"kernels (secular_roots, fused_update, resident_merge, "
              f"deflate_chain) in the phase (mixed and certified trees) "
              f"{tree_launches}")
        if min(sturm_launches) == 0:
            raise AssertionError(f"a Sturm kernel never launched on its "
                                 f"path: {sturm_launches}")
        if not (per_range[0] == 0 and per_range[1] == 2
                and 1 <= per_range[2] <= 7):
            raise AssertionError(f"the n=16384 range solve launched "
                                 f"{per_range}, not 0 count sweeps, 2 Newton "
                                 f"sweeps and at most 7 tree trips")
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

        # ---- phase 7: the comparison points (references keep running) ---
        two_pass = (zhat_reconstruct_cuda, boundary_rows_update_cuda)
        every = kernels + sturm_kernels + two_pass + (sterf_cuda,)
        names = [k.__name__ for k in every]
        for k in every:
            k.launches = 0
        deflate_chain_cuda.apply_launches = 0
        cmp = {}

        def drive(label, key, fn, reps=1):
            """One run (launch counts and peak memory), then the time:
            median of ``reps`` between CUDA events after a warm-up, or that
            one run when reps == 1."""
            before = [k.launches for k in every]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            lam, ms = _cuda_once(torch, fn)
            # The solve's own peak: what it allocated above the tensors
            # that were already live when it started.
            peak = torch.cuda.max_memory_allocated() - base
            used = dict(zip(names, (k.launches - b
                                    for k, b in zip(every, before))))
            if reps > 1:
                ms = _cuda_ms(torch, fn, reps)
            cmp[label] = dict(lam=lam.cpu().numpy(), key=key, used=used,
                              ms=ms, peak=peak, reps=reps)
            return cmp[label]

        Dg, Eg = batches["glued_wilkinson"]
        for fam, d, e in (("uniform", Du[0], Eu[0]),
                          ("glued_wilkinson", Dg[0], Eg[0])):
            for m in ("sterf", "lazy", "full", "eigh", "br"):
                drive(f"{m} n=4096 {fam}", (fam, 0),
                      lambda: eigvalsh_tridiagonal(d, e, method=m))
            drive(f"br fused=False n=4096 {fam}", (fam, 0),
                  lambda: eigvalsh_tridiagonal(d, e, fused=False))
        lazy_cert = execute_request(SolveRequest(
            d=Du[0], e=Eu[0], method="lazy", certify=True))
        cmp["lazy certify=True n=4096 uniform"] = dict(
            lam=lazy_cert.eigenvalues.cpu().numpy(), key=("uniform", 0),
            used=None, ms=None, peak=None, reps=0)
        for fused in (True, False):
            drive(f"br{'' if fused else ' fused=False'} B=64 x 4096 "
                  f"uniform", "uniform batch",
                  lambda: eigvalsh_tridiagonal_batch(
                      Du, Eu, fused=fused).eigenvalues, reps=5)
        # The leaf solve alone (one batched torch.linalg.eigh of the 32 x 32
        # blocks) at the batch's and the n = 16384 solve's counts, for the
        # peaks above.
        for blocks in (64 * 128, 512):
            A = torch.randn(blocks, 32, 32, dtype=torch.float64, device=dev)
            A = A + A.transpose(1, 2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.linalg.eigh(A)
            torch.cuda.synchronize()
            print(f"[7 memory] torch.linalg.eigh of {blocks} 32 x 32 "
                  f"blocks (the leaf solve): peak "
                  f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f}"
                  f" MiB over its {A.numel() * 8 / 2**20:.1f} MiB input")
            del A
        # n = 16384: the BR routes timed as a median of 5, the quadratic
        # ones and sterf once.  sterf's QL work grows as n^2, so its
        # n = 4096 time predicts the n = 16384 one.
        big = {}
        ref8 = None
        big["br"] = drive("br n=16384 uniform", "u16",
                          lambda: eigvalsh_tridiagonal(d16, e16), reps=5)
        big["br fused=False"] = drive(
            "br fused=False n=16384 uniform", "u16",
            lambda: eigvalsh_tridiagonal(d16, e16, fused=False), reps=5)
        for m in ("lazy", "full"):
            big[m] = drive(f"{m} n=16384 uniform", "u16",
                           lambda: eigvalsh_tridiagonal(d16, e16, method=m))
        predicted_s = cmp["sterf n=4096 uniform"]["ms"] * 16 / 1e3
        if predicted_s > CUT_S:
            print(f"[7 compare] sterf at n=16384 is cut to n=8192: its "
                  f"n=4096 time predicts {predicted_s:.1f} s (QL work grows "
                  f"as n^2), over the {CUT_S:.0f} s limit of one solve")
            d8, e8 = make_family("uniform", 8192, seed=0)
            big["sterf"] = drive("sterf n=8192 uniform", "u8",
                                 lambda: eigvalsh_tridiagonal(
                                     d8, e8, method="sterf"))
            big["sterf"]["n"] = 8192
            scale8 = eps * max(1.0, _tinf(d8, e8))
            ref8 = pool.submit(_reference, d8, e8, big["sterf"]["lam"],
                               8 * scale8)
        else:
            big["sterf"] = drive("sterf n=16384 uniform", "u16",
                                 lambda: eigvalsh_tridiagonal(
                                     d16, e16, method="sterf"))
        phase7 = dict(zip(names, (k.launches for k in every)))
        apply_phase7 = deflate_chain_cuda.apply_launches
        ql_d = torch.tensor(Du[0], device=dev)[None]
        ql_e = torch.tensor(Eu[0], device=dev)[None]
        (ql_lam, ql_steps), ql_ms = _cuda_once(
            torch, lambda: sterf_cuda(ql_d, ql_e))
        # The library call for the same function: torch.linalg.eigvalsh of
        # the dense T, formed before the clock starts.
        ql_dense = (torch.diag(ql_d[0]) + torch.diag(ql_e[0], 1)
                    + torch.diag(ql_e[0], -1))
        ql_lib_ms = _cuda_ms(torch, lambda: torch.linalg.eigvalsh(ql_dense),
                             reps=3)
        del ql_dense
        print(f"[7 compare] launches in the phase: {phase7}")
        for label, c in cmp.items():
            if c["used"] is None:
                continue
            used = {k: v for k, v in c["used"].items() if v}
            print(f"[7 compare] {label}: {c['ms']:.1f} ms"
                  f"{' (median of 5)' if c['reps'] > 1 else ' (one run)'}; "
                  f"own peak device memory {c['peak'] / 2**20:.1f} MiB; "
                  f"launches {used}")
        for label, c in cmp.items():
            if c["used"] is None:
                continue
            two = [c["used"][k.__name__] for k in two_pass]
            if ("lazy" in label or "full" in label
                    or "fused=False" in label) and min(two) == 0:
                raise AssertionError(f"{label}: a two-pass kernel never "
                                     f"launched: {two}")
            if "sterf" in label and c["used"]["sterf_cuda"] == 0:
                raise AssertionError(f"{label}: the QL kernel never "
                                     f"launched")
        n_ql = big["sterf"].get("n", 16384)
        models = {"br": workspace_model(16384)["total_bytes"],
                  "br fused=False": workspace_model(16384)["total_bytes"],
                  "lazy": bl.workspace_model_lazy(16384)["persistent_bytes"],
                  "full": bl.workspace_model_full(16384)["persistent_bytes"],
                  "sterf": bl.workspace_model_sterf(n_ql)["persistent_bytes"]}
        for m, c in big.items():
            print(f"[7 memory] {m} n={c.get('n', 16384)}: own peak device "
                  f"memory {c['peak'] / 2**20:.1f} MiB, model "
                  f"({'workspace_model' if m.startswith('br') else 'workspace_model_' + m}) "
                  f"{models[m] / 2**20:.1f} MiB; time {c['ms']:.1f} ms "
                  f"({'median of 5' if c['reps'] > 1 else 'one run'}, "
                  f"{smi})")

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
        ql_plain, ql_plain_s = plain_ql.result()
        if ref8 is not None:
            refs["u8"] = (ref8.result()[0], scale8)
    finally:
        pool.shutdown(cancel_futures=True)
    for label, (ratio, redo, redo_err) in worst.items():
        print(f"[3 main] {label}: max error {ratio:.2f} eps*||T||_inf vs "
              f"scipy (bar 64); {redo} eigenvalues where the default driver "
              f"differs by > 8 were re-solved with stebz, max error there "
              f"{redo_err:.2f}")

    # ---- phase 6 checks: every Sturm-path spectrum vs the references ----
    held = {}

    def hold(label, got, key, sl, br=None, bar=64.0):
        """got vs the phase-3 reference at ``bar`` eps (64, the
        conformance bar, unless a method documents another) and, for range
        results, vs the full BR solve ``br`` at 8 eps."""
        ref, scale = refs[key]
        ref = ref[sl]
        if not (got.shape == ref.shape and np.isfinite(got).all()):
            raise AssertionError(f"{label}: bad output {got.shape}")
        r64 = float(np.abs(got - ref).max()) / scale if got.size else 0.0
        r8 = (float(np.abs(got - br[sl]).max()) / scale
              if br is not None and got.size else None)
        w = held.setdefault(label, [0.0, None, bar])
        w[0] = max(w[0], r64)
        if r8 is not None:
            w[1] = max(w[1] or 0.0, r8)
        if r64 > bar or (r8 is not None and r8 > 8):
            raise AssertionError(f"{label}: {r64:.2f} eps*||T||_inf from "
                                 f"the reference (bar {bar:.0f}), {r8} from "
                                 f"the BR solve (bar 8)")

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
    for label, (r64, r8, _) in held.items():
        print(f"[6 sturm] {label}: max error {r64:.2f} eps*||T||_inf vs the "
              f"reference (bar 64)"
              + (f", {r8:.2f} vs the full BR solve (bar 8)"
                 if r8 is not None else ""))
    # ---- phase 7 checks: every comparison point vs the references ------
    # sterf's error grows as sqrt(n) (see _sterf_bar): it is held to
    # _sterf_bar(n), the others to the conformance bar of 64.
    for label, c in cmp.items():
        lam, key = c["lam"], c["key"]
        if key == "uniform batch":
            for b in range(lam.shape[0]):
                hold(label, lam[b], ("uniform", b), slice(None))
            continue
        bar = _sterf_bar(lam.size) if label.startswith("sterf") else 64.0
        hold(label, lam, key, slice(None), bar=bar)
    for label, c in cmp.items():
        print(f"[7 compare] {label}: max error {held[label][0]:.2f} "
              f"eps*||T||_inf vs the reference (bar {held[label][2]:.0f})")
    # At n = 4096 both runs are off by tens of eps and their trajectories
    # part: held to each other at _sterf_bar(4096).
    ql_err = float(np.abs(ql_lam[0].cpu().numpy() - ql_plain).max())
    ql_unit = eps * max(1.0, _tinf(Du[0], Eu[0]))
    ql_bar = _sterf_bar(4096) * ql_unit
    print(f"[7 compare] sterf kernel n=4096 uniform: {ql_ms:.1f} ms (one "
          f"run), {int(ql_steps[0])} rotations, "
          f"{ql_ms * 1e6 / int(ql_steps[0]):.1f} ns per rotation (chain "
          f"bound {ql_chain['ns_per_rotation'] * int(ql_steps[0]) / 1e6:.1f}"
          f" ms: {ql_chain['ns_per_rotation']:.2f} ns per rotation); plain "
          f"loop on the CPU {ql_plain_s:.1f} s; max diff {ql_err:.3e} = "
          f"{ql_err / ql_unit:.2f} eps*||T||_inf (bar "
          f"{_sterf_bar(4096):.0f}); library torch.linalg.eigvalsh of the "
          f"pre-formed dense T {ql_lib_ms:.1f} ms (median of 3); the "
          f"kernel takes {ql_ms / ql_lib_ms:.1f}x the library's time ({smi})")
    if not ql_err <= ql_bar:
        raise AssertionError(f"sterf kernel vs plain at n=4096: {ql_err}")

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
    tg = _cuda_ms(torch, lambda: eigvalsh_tridiagonal(Dg[0], Eg[0]))
    tg64 = _cuda_ms(torch, lambda: eigvalsh_tridiagonal_batch(Dg, Eg))
    print(f"[5 time] eigvalsh_tridiagonal n=4096 glued_wilkinson f64: "
          f"{tg:.1f} ms; eigvalsh_tridiagonal_batch B=64 n=4096 "
          f"glued_wilkinson f64: {tg64:.1f} ms (median of 5, {smi})")
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
    _profile(torch, "n=4096 glued_wilkinson solve",
             lambda: eigvalsh_tridiagonal(Dg[0], Eg[0]))
    _profile(torch, "range bottom 64, n=16384", sturm_paths[
        "range bottom 64, n=16384"])
    _profile(torch, "mixed, n=16384", sturm_paths["mixed, n=16384"])
    _profile(torch, "mixed, B=64 x 4096", sturm_paths["mixed, B=64 x 4096"])
    _profile(torch, "br fused=False, n=16384", lambda: eigvalsh_tridiagonal(
        d16, e16, fused=False))
    _profile(torch, "full, n=16384", lambda: eigvalsh_tridiagonal(
        d16, e16, method="full"))
    _profile(torch, "lazy, n=16384", lambda: eigvalsh_tridiagonal(
        d16, e16, method="lazy"))

    # ---- phase 8: the eigensolver service --------------------------------
    serve_launches = _phase8(torch, np, smi)

    # ---- phase 9: tuning, SLQ, sharpness and the governor ----------------
    phase9_launches = _phase9(torch, np, smi, Du, Eu, refs)

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
                    "bound_by": by, "library_ms": rec.get("library_ms")})
        if name in ("secular_roots", "resident_merge"):
            regs, st, ld = design[name]["float64"]
            out[-1].update(library=rec["library"], team=rmod.TEAM,
                           registers_f64=regs, spill_bytes_f64=st + ld,
                           achieved_ops_per_s=rec["flops"] / (rec["ms"] * 1e-3))
        if name == "resident_merge":
            shp, mac = design["resident_shape"]
            out[-1].update(cluster=shp.cluster, cta_threads=shp.threads,
                           clusters_at_once=mac)
        if name == "fused_update":
            out[-1].update(
                redesigned="a team per pole, then per root column",
                team=rmod.TEAM,
                shape="B=8 r=3 K=2048 kprime=1536 f64",
                pass_a_threads=wdesign["WEIGHT_THREADS"],
                pass_a_tile=wdesign["WEIGHT_TILE"],
                pass_b_threads=rdesign["ROWS_THREADS"],
                pass_b_tile=rdesign["ROWS_TILE"],
                registers_f64=[design["zhat"]["float64"][0],
                               design["fused_update"]["float64"][0]],
                fp64_per_pair=[c and c[0] for c in (pa, pb)],
                instructions_per_pair=[c and c[1] for c in (pa, pb)],
                fp64_instr_bound_ms=instr_bounds["fused_update"][0],
                issue_slot_ms=instr_bounds["fused_update"][1],
                sm_clock_mhz=sm_hz / 1e6)
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
        "trip_shape": "B=1 n=16384 S=64 f64",
        "trip_ms": trip["sturm_count"]["ms"],
        "trip_plain_ms": trip["sturm_count"]["plain_ms"],
        "trip_bound_ms": bounds["trip", 0][0],
        "trip_chain_bound_ms": trip["chain_ms"],
        "chain_ns_per_row": trip["chain_ns_row"],
        "chain_cycles_per_row": trip["chain_cycles_row"],
        "trip_chain_rows": trip["n"],
        "fp64_per_row": counts["sturm_count"] and counts["sturm_count"][0],
        "instructions_per_row": (counts["sturm_count"]
                                 and counts["sturm_count"][1]),
        "fp64_instr_bound_ms": instr_bounds["sturm_count"][0],
        "issue_slot_ms": instr_bounds["sturm_count"][1],
        "sm_clock_mhz": sm_hz / 1e6})
    out.append({
        "name": "sturm_count_newton", "route": "cuda",
        "source": "src/repro_torch/csrc/sturm_count.cu",
        "replaces": "src/repro/core/bisect.py:155 (XLA scan, not Pallas)",
        "launches": int(sturm_launches[1]),
        "max_abs_err": newton["max_abs_err"], "ms": newton["ms"],
        "plain_ms": newton["plain_ms"], "bound_ms": bounds["certify", 1][0],
        "bound_by": bounds["certify", 1][1], "library_ms": None,
        "shape": "B=64 n=4096 S=8192 f64", "bitwise": newton["bitwise"],
        "trip_ms": trip["sturm_count_newton"]["ms"],
        "trip_plain_ms": trip["sturm_count_newton"]["plain_ms"],
        "trip_bound_ms": bounds["trip", 1][0],
        "fp64_per_row": (counts["sturm_count_newton"]
                         and counts["sturm_count_newton"][0]),
        "instructions_per_row": (counts["sturm_count_newton"]
                                 and counts["sturm_count_newton"][1]),
        "fp64_instr_bound_ms": instr_bounds["sturm_count_newton"][0],
        "issue_slot_ms": instr_bounds["sturm_count_newton"][1],
        "sm_clock_mhz": sm_hz / 1e6})
    # The tree launch replaces m halvings of every bracket: its bound is
    # one count sweep a live halving (the run's own, B * k * m from the
    # Gershgorin brackets), not the 2^m - 1 node sweeps the kernel spends
    # on speculation, and the bytes of lo, hi and the inputs.
    # ``chain_bound_ms`` is the chain probe over the problem's rows, the
    # least time of any launch that walks the recurrence row by row.
    tr, tedge = record[("tree", "range")], record[("tree", "edges")]
    tree_bound = {}
    for key, r in (("range", tr), ("edges", tedge)):
        tree_bound[key] = _bound_ms(
            _sturm_ops(1, r["n"], r["halvings"], False),
            _tree_bytes(r["B"], r["n"], r["k"]), "float64")
    out.append({
        "name": "sturm_bisect_tree", "route": "cuda",
        "source": "src/repro_torch/csrc/sturm_count.cu",
        "replaces": "src/repro/kernels/sturm_count.py:63 (with the "
                    "bisection loop of src/repro/core/bisect.py)",
        "launches": int(sturm_launches[2]),
        "max_abs_err": tr["max_abs_err"], "ms": tr["ms"],
        "plain_ms": tr["plain_ms"], "bound_ms": tree_bound["range"][0],
        "bound_by": tree_bound["range"][1], "library_ms": None,
        "shape": f"B=1 n=16384 k=64 depth={tr['depth']} f64 (one launch: "
                 f"{tr['depth']} halvings)",
        "halvings": tr["halvings"],
        "chain_bound_ms": chain_ms,
        "launches_per_range_solve": int(per_range[2]),
        "edges_shape": f"B=128 n=4096 k=8 depth={tedge['depth']} f64",
        "edges_ms": tedge["ms"], "edges_plain_ms": tedge["plain_ms"],
        "edges_bound_ms": tree_bound["edges"][0],
        "edges_halvings": tedge["halvings"],
        "edges_chain_bound_ms": chain_ms * tedge["n"] / trip["n"],
        "fp64_per_row": (counts["sturm_bisect_tree"]
                         and counts["sturm_bisect_tree"][0]),
        "instructions_per_row": (counts["sturm_bisect_tree"]
                                 and counts["sturm_bisect_tree"][1]),
        "fp64_instr_bound_ms": instr_bounds["sturm_bisect_tree"][0],
        "issue_slot_ms": instr_bounds["sturm_bisect_tree"][1],
        "sm_clock_mhz": sm_hz / 1e6})
    zb, zb_by = _bound_ms(zr["flops"], zr["nbytes"], "float64")
    z16 = record[("zhat", 16384)]
    out.append({
        "name": "zhat", "route": "cuda",
        "source": "src/repro_torch/csrc/zhat.cu",
        "replaces": "src/repro/kernels/zhat.py:80",
        "launches": int(phase7["zhat_reconstruct_cuda"]),
        "max_abs_err": zr["max_abs_err"], "ms": zr["ms"],
        "plain_ms": zr["plain_ms"], "bound_ms": zb, "bound_by": zb_by,
        "library_ms": None,
        "shape": f"B={zr['B']} K={zr['K']} kprime={zr['kp']} f64",
        "redesigned": "a team per pole", "team": rmod.TEAM,
        "threads": wdesign["WEIGHT_THREADS"], "tile": wdesign["WEIGHT_TILE"],
        "registers_f64": design["zhat"]["float64"][0],
        "fp64_per_pair": counts["zhat"] and counts["zhat"][0],
        "instructions_per_pair": counts["zhat"] and counts["zhat"][1],
        "fp64_instr_bound_ms": instr_bounds["zhat"][0],
        "issue_slot_ms": instr_bounds["zhat"][1],
        "sm_clock_mhz": sm_hz / 1e6,
        "k16384_shape": f"B=1 K=16384 kprime={z16['kp']} f64",
        "k16384_ms": z16["ms"], "k16384_plain_ms": z16["plain_ms"],
        "k16384_max_abs_err": z16["max_abs_err"],
        "k16384_bound_ms": _bound_ms(z16["flops"], z16["nbytes"],
                                     "float64")[0],
        "k16384_fp64_instr_bound_ms": _instr_bounds_ms(
            counts["zhat"], z16["pairs"], sm_hz, sms)[0]})
    for r, K in ((4096, 4096), (3, 8192)):
        br_ = record[("boundary", r, K)]
        fma, rest = br_["ops"]
        t_ops = fma / PEAK_FP64_TENSOR + rest / PEAK_FLOPS["float64"]
        t_bytes = br_["nbytes"] / PEAK_BYTES
        br_["bound"] = (max(t_ops, t_bytes) * 1e3,
                        "operations" if t_ops >= t_bytes else "bytes")
        br_["bound_no_tensor_ms"] = max(
            (fma + rest) / PEAK_FLOPS["float64"], t_bytes) * 1e3
    bk, b3 = record[("boundary", 4096, 4096)], record[("boundary", 3, 8192)]
    out.append({
        "name": "boundary_update", "route": "cuda",
        "source": "src/repro_torch/csrc/boundary_update.cu",
        "replaces": "src/repro/kernels/boundary_update.py:85",
        "launches": int(phase7["boundary_rows_update_cuda"]),
        "max_abs_err": bk["max_abs_err"], "ms": bk["ms"],
        "plain_ms": bk["plain_ms"], "bound_ms": bk["bound"][0],
        "bound_by": bk["bound"][1], "library_ms": bk["library_ms"],
        "library": "torch.matmul of a pre-formed Y (product only)",
        "shape": f"B=1 r=K=4096 kprime={bk['kp']} f64",
        "bound_no_tensor_ms": bk["bound_no_tensor_ms"],
        "r3_shape": f"B=2 r=3 K=8192 kprime={b3['kp']} f64",
        "r3_ms": b3["ms"], "r3_plain_ms": b3["plain_ms"],
        "r3_bound_ms": b3["bound"][0], "r3_library_ms": b3["library_ms"],
        "r3_max_abs_err": b3["max_abs_err"]})
    steps = int(ql_steps[0])
    qb, qb_by = _bound_ms(19.0 * steps, 3 * 4096 * 8, "float64")
    out.append({
        "name": "sterf", "route": "cuda",
        "source": "src/repro_torch/csrc/sterf.cu",
        "replaces": "src/repro/core/sterf.py:86 (XLA loop, not Pallas)",
        "launches": int(phase7["sterf_cuda"]),
        "max_abs_err": ql_err, "ms": ql_ms, "plain_ms": ql_plain_s * 1e3,
        "bound_ms": qb, "bound_by": qb_by, "library_ms": ql_lib_ms,
        "library": "torch.linalg.eigvalsh of a pre-formed dense T",
        "shape": "B=1 n=4096 uniform f64 (one run; plain on the CPU)",
        "rotations": steps, "ns_per_rotation": ql_ms * 1e6 / steps,
        "chain_bound_ms": ql_chain["ns_per_rotation"] * steps / 1e6,
        "chain_ns_per_rotation": ql_chain["ns_per_rotation"],
        "chain_cycles_per_rotation": ql_chain["cycles_per_rotation"],
        "sterf_n16384_ms": big["sterf"]["ms"] if n_ql == 16384 else None})
    dc = chain_cases["glued_wilkinson W=64 r=3 K=2048"]
    du = chain_cases["uniform W=1 r=3 K=16384"]
    dk = {K: chain_cases[label] for K, label in (
        (512, "glued_wilkinson W=8 r=K=512"),
        (2048, "glued_wilkinson lazy W=2 r=K=2048"),
        (4096, "glued_wilkinson lazy W=1 r=K=4096"))}
    out.append({
        "name": "deflate_chain", "route": "cuda",
        "source": "src/repro_torch/csrc/deflate_chain.cu",
        "replaces": "src/repro/core/merge.py:69/:186 (XLA scan, not Pallas)",
        "launches": int(launches[3]), "max_abs_err": dc["max_abs_err"],
        "ms": dc["ms"], "plain_ms": dc["plain_ms"],
        "bound_ms": dc["bound"][0], "bound_by": dc["bound"][1],
        "library_ms": None,
        "shape": "W=64 r=3 K=2048 glued_wilkinson f64 (dependent steps of "
                 "the longest lane x the chain probe's step)",
        "head_ms": dc["head_ms"], "steps": dc["steps"],
        "rotations": dc["rotations"], "chain_ns_per_step": step_ns,
        "chain_cycles_per_step": step_cycles,
        "chain_bound_ms": dc["chain_bound_ms"],
        "bytes_bound_ms": dc["bytes_bound_ms"],
        "u16_shape": "W=1 r=3 K=16384 uniform f64", "u16_ms": du["ms"],
        "u16_plain_ms": du["plain_ms"], "u16_head_ms": du["head_ms"],
        "u16_bound_ms": du["bound"][0], "u16_steps": du["steps"],
        "u16_max_abs_err": du["max_abs_err"],
        "redesigned": "split route for r >= SPLIT_MIN_R: the rotations "
                      "decided on one warp a lane, applied to R's rows "
                      "across the card",
        "split_min_r": dck.SPLIT_MIN_R,
        "apply_launches": int(apply_phase7),
        "apply_launches_main": int(apply_main),
        "r_is_k": {str(K): dict(
            shape=shape, route=dk[K]["shape"].route,
            **{k: dk[K][k] for k in (
                "ms", "plain_ms", "head_ms", "steps", "rotations",
                "chain_bound_ms", "bytes_bound_ms", "max_abs_err")},
            bound_ms=dk[K]["bound"][0])
            for K, shape in (
                (512, "W=8 r=K=512 glued_wilkinson f64 (R = I)"),
                (2048, "W=2 r=K=2048 glued lazy n=4096 f64"),
                (4096, "W=1 r=K=4096 glued lazy n=4096 f64"))}})
    for rec in out:   # phases 8 and 9's own counts, beside the main path's
        rec["serve_launches"] = int(serve_launches.get(rec["name"], 0))
        rec["phase9_launches"] = int(phase9_launches.get(rec["name"], 0))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
