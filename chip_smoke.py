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
     update that scale times the ungoverned one, and the loss falling;
 10. trains and serves qwen3-0.6b at full width (28 layers, d_model 1024,
     GQA 16/8 heads of 128, d_ff 3072, vocab 151936) in bfloat16 through
     the port's drivers, the kernels' launch counts zeroed at the phase's
     start: (a) ``launch.train.main`` takes 20 adamw steps at batch 8 x
     seq 256 with a curvature probe every 5 steps (m = 8 Lanczos steps of
     the ``torch.func`` HVP on a 2-sequence sub-batch, the k = 1 edges
     solve served through an ``EigensolverClient``), its target 50, below
     the model's lam_max, so the governor damps; checks finite, falling
     losses, every probe's lr_scale == max(min_scale, min(1, target /
     lam_max)) and applied until the next probe, one below 1, a governor
     fed direct solves of the same tridiagonals walking the same values
     bit for bit, the edges bucket's requests == probes + 1 with 0 errors,
     and the bisection tree and the Newton sweep launched; prints the step
     time (CUDA events, median after the first), tokens/s, peak device
     memory and each probe's wall and its solve's share; (b) under
     ``torch.use_deterministic_algorithms`` trains 10 steps saving every
     5, moves the step-10 checkpoint aside, resumes from step 5 and holds
     the resumed run's losses and final state to the uninterrupted run's
     bit for bit, and the step-10 checkpoint, restored, to the
     uninterrupted run's final state bit for bit; (c) ``launch.serve.main``
     prefills 4 x 128-token prompts and greedy-decodes 32 tokens, then the
     same decode's logits are held step by step against a teacher-forced
     ``forward`` of the prompt and the generated prefix within 16
     bfloat16 eps of the step's largest |logit|, printing the prefill
     time, decode tokens/s and the fraction of greedy ids that agree
     with the forward's argmax; then traces one decode step and one
     adamw step with torch.profiler (device busy share, top kernels).
 11. drives the distributed conquer on the card, P shards sharing it
     through ``make_solver_mesh(P, devices=["cuda:0"] * P)``, the kernels'
     launch counts (every kernel's, the root-window entry's apart) zeroed
     just before (b) and read just after (f): (b) ``eigvalsh_tridiagonal``
     of uniform and glued Wilkinson at n = 16384 and 65536, f64, mesh = 1,
     2 and 4, each sharded result equal to mesh = 1 bit for bit, with the
     window launches counted against the levels' rule, and mesh = 1 held
     at 64 eps ||T||_inf, after the counts are read, to phase 3's
     reference (uniform n = 16384) or to stebz at 206 indices and numpy
     Sturm counts at every index (the others: scipy's default driver
     takes over a minute at n = 65536 and is off by more than 8 eps ||T||
     at most indices, and a full stebz takes tens of ms an index); (c) a host-padded B = 8 batch of n
     in 12000-16384 with boundary rows through ``make_plan(...).execute(
     orig_n=)``, mesh = 4 == mesh = 1 bit for bit (eigenvalues, blo, bhi);
     (d) ``fused=False`` at n = 16384, mesh = 4 == mesh = 1 bit for bit,
     zhat and the row update launched; (e) ``compress_halo=True`` within
     0.05 ||T||, off == mesh = 1; (f) 8 n = 16384 requests served on the
     mesh = 2 route == the sync calls bit for bit, with 0 errors,
     fallbacks and retries; (g) times every (b) solve (CUDA events, median
     of 5) beside the transition all-gather's bytes and peak device
     memory; and (a) holds the root-window entry of the root-solve kernel
     to the full launch's columns bit for bit and to its plain version at
     1e-13 (a zeroed and a sign-flipped tau fail that bar) at B = 1,
     K = 16384 (four windows of 4096) and B = 8, K = 8192 (two), timing a
     window beside the full launch and its bound.
 12. trains qwen3-0.6b at full width (bfloat16) on four ranks that share
     the card (``torch.distributed`` over gloo, spawned processes, DTensor
     collectives staged through host memory by ``dist.host_staged``),
     every kernel's launch count zeroed at each rank's start and read at
     its end: (a) ``launch.train.main --devices 4 --model-parallel 2``,
     mesh (data 2, model 2), 6 adamw steps at batch 8 x seq 256 with a
     served probe every 2 steps, held to a one-rank run of the same steps
     (same seed: same parameters and batches) at 8 bfloat16 eps relative
     per step (loss and grad norm), every rank's ``lr_scale`` equal,
     the bisection tree and the Newton sweep launched, each rank's
     parameter and optimizer bytes the rules' share to the byte, each
     rank's peak memory and step times (CUDA events) printed, and one more
     step's collectives counted (``CommDebugMode``) beside the bytes the
     host staging carried; (b) world size 1 on NCCL, mesh (1, 1): one
     step on ``DTensor``s (``make_mesh_for(1)``, ``param_shardings``,
     ``distribute_tree``) equal to the one-device step bit for bit; (c) the
     int8 compressed step on (pod 2, data 1, model 2), two steps: step 0's
     loss within the bound of (a) of the one-rank loss, step 1's within
     1e-2 relative (one adamw update, whose int8-rounded gradient zeroes
     the sign of elements below half a quantization step), and each
     rank's int8 payload plus residual equal to its float32 gradient at
     1e-6 relative, the mean equal to the pods' average payload; (d) the
     pipelined step on (pod 2, data 2, model 1), n_micro 4: the step-0
     loss within the bound of (a) of the one-rank loss; (e) (a)'s step-4
     checkpoint restored onto one rank and onto (data 1, model 2) (two
     ranks), every leaf equal to the saved array bit for bit (its CRC32).

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


def _profile(torch, label, fn, tag="5 profile"):
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
        print(f"[{tag}] {label}: device time not measured (the tracer "
              f"recorded none); wall {wall_ms:.1f} ms")
        return
    top = "; ".join(f"{k[:60]} x{c} {ms:.2f} ms" for ms, k, c in rows[:6])
    print(f"[{tag}] {label}: wall {wall_ms:.1f} ms (traced), device "
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


def _phase10(torch, np, smi):
    """Phase 10: the model zoo's trainer and serving driver on the card at
    the full width of qwen3-0.6b in bfloat16 (see the module docstring).
    Raises on any failed check; returns the phase's launch counts by
    kernel name."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as ttf
    from repro_torch.optim import SpectralGovernor, adamw
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda", 0)
    arch, B, S, steps, every, m, pb = "qwen3-0.6b", 8, 256, 20, 5, 8, 2
    cfg = get_config(arch)
    kernels = {"resident_merge": resident_merge_cuda,
               "secular_roots": secular_solve_cuda,
               "fused_update": secular_postpass_cuda,
               "deflate_chain": deflate_chain_cuda,
               "sturm_count": sturm_count_cuda,
               "sturm_count_newton": sturm_count_newton_cuda,
               "sturm_bisect_tree": sturm_bisect_tree_cuda}
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="repro-torch-phase10-")
    common = ["--arch", arch, "--batch", str(B), "--seq", str(S),
              "--log-every", "100"]
    try:
        # ---- (a) 20 governed adamw steps at full width -------------------
        # The target lies below this model's lam_max over these steps (the
        # probes read 142-160, and 303 at the initial parameters, on one
        # H100), so the governor damps; the phase checks that it did.
        target = 50.0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        rep = ttrain.main(common + [
            "--steps", str(steps), "--spectral-every", str(every),
            "--serve-monitor", "--probe-steps", str(m), "--probe-batch",
            str(pb), "--target-sharpness", repr(target), "--ckpt-every",
            "100000", "--ckpt-dir", os.path.join(work, "a")])
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        trained = {name: k.launches for name, k in kernels.items()}
        losses, log = rep["losses"], rep["probe_log"]
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0] and len(losses) == steps):
            raise AssertionError(f"train: losses {losses}")
        lo = rep["min_scale"]
        if not log["steps"] or log["steps"] != list(range(every, steps,
                                                          every)):
            raise AssertionError(f"train: probes at {log['steps']}")
        for step, lam, scale in zip(log["steps"], log["lam_max"],
                                    log["lr_scale"]):
            want = max(lo, min(1.0, target / lam))
            applied = rep["lr_scales"][step + 1:step + 1 + every]
            if not (scale == want and lo <= scale <= 1.0
                    and all(x == scale for x in applied)):
                raise AssertionError(
                    f"train: probe at step {step}: lr_scale {scale!r}, "
                    f"expected max(min_scale, min(1, {target!r} / "
                    f"{lam!r})) = {want!r}; applied {applied}")
        if min(rep["lr_scales"]) >= 1.0 or target >= log["lam_max"][0]:
            raise AssertionError(f"train: the governor never damped "
                                 f"(target {target}, lam_max "
                                 f"{log['lam_max']})")
        # The served probes against direct solves of the same Krylov
        # tridiagonals: a governor fed by direct edges solves on the card
        # walks the same lam_max (EMA) and lr_scale, bit for bit.
        replay = SpectralGovernor(period=every, target_sharpness=target)
        for (alpha, beta), lam, scale in zip(log["tridiags"],
                                             log["lam_max"],
                                             log["lr_scale"]):
            got = replay.probe_tridiag(alpha.to(dev), beta.to(dev))
            if replay.lam_max != lam or got != scale:
                raise AssertionError(
                    f"train: served probe lam_max {lam!r} / scale "
                    f"{scale!r} != direct {replay.lam_max!r} / {got!r}")
        bucket = rep["serve"]["buckets"][f"range/n{m}/k1/float64"]
        errors = sum(b["errors"] for b in rep["serve"]["buckets"].values())
        if bucket["requests"] != rep["probes"] + 1 or errors:
            raise AssertionError(f"train: edges bucket {bucket}, errors "
                                 f"{errors}, probes {rep['probes']}")
        for name in ("sturm_bisect_tree", "sturm_count_newton"):
            if trained[name] == 0:
                raise AssertionError(f"train: {name} never launched")
        step_ms = statistics.median(rep["step_event_ms"][1:])
        print(f"[10 train] {arch} full width (28 layers, d_model 1024, "
              f"vocab 151936, bfloat16), adamw, batch {B} x seq {S}, "
              f"{steps} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"step {step_ms:.1f} ms (CUDA events, median of steps 2-"
              f"{steps}), {B * S / step_ms * 1e3:.0f} tokens/s; peak device "
              f"memory {peak / 2**30:.2f} GiB; {steps} steps with probes "
              f"{train_s:.1f} s host wall ({smi})")
        for step, lam, scale, wall, solve in zip(
                log["steps"], log["lam_max"], log["lr_scale"],
                log["wall_s"], log["solve_s"]):
            print(f"[10 probe] step {step}: m={m} Lanczos on a {pb} x {S} "
                  f"sub-batch + served edges solve {wall * 1e3:.1f} ms, the "
                  f"solve {solve * 1e3:.1f} ms ({solve / wall:.1%}); lam_max "
                  f"(EMA) {lam:.6g}, target {target:.6g}, lr_scale "
                  f"{scale:.6g} == max(min_scale, min(1, target / lam_max)),"
                  f" == the direct solve's bit for bit ({smi})")
        print(f"[10 probe] edges bucket {bucket['requests']} requests "
              f"(probes + the warm-up), 0 errors; launches in the run: "
              f"{trained}")
        del rep, log

        # ---- (b) checkpoint: save, restore, resume ------------------------
        # Bit for bit under torch.use_deterministic_algorithms (cuBLAS on
        # one stream; the embedding's and the gold logit's backward are
        # accumulating index_puts, which have a deterministic kernel).
        env = "CUBLAS_WORKSPACE_CONFIG"
        old_env = os.environ.get(env)
        os.environ.setdefault(env, ":4096:8")
        torch.use_deterministic_algorithms(True)
        ck = os.path.join(work, "b")
        half = 5
        try:
            t0 = time.perf_counter()
            full = ttrain.main(common + ["--steps", str(2 * half),
                                         "--ckpt-every", str(half),
                                         "--ckpt-dir", ck])
            full_s = time.perf_counter() - t0
            kept = os.path.join(work, "uninterrupted")
            os.makedirs(kept)
            os.rename(os.path.join(ck, f"step_{2 * half:08d}"),
                      os.path.join(kept, f"step_{2 * half:08d}"))
            t0 = time.perf_counter()
            resumed = ttrain.main(common + ["--steps", str(2 * half),
                                            "--ckpt-every", "100000",
                                            "--ckpt-dir", ck])
            resumed_s = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
            if old_env is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = old_env
        state = tree_leaves(full["state"])
        if resumed["start_step"] != half or (resumed["losses"]
                                             != full["losses"][half:]):
            raise AssertionError(f"ckpt: resumed at {resumed['start_step']}"
                                 f", losses {resumed['losses']} vs "
                                 f"{full['losses'][half:]}")
        if not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                   zip(tree_leaves(resumed["state"]), state)):
            raise AssertionError("ckpt: resumed state != uninterrupted")
        del resumed
        t0 = time.perf_counter()
        restored, _ = restore_tree(kept, 2 * half, full["state"])
        restore_s = time.perf_counter() - t0
        if not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                   zip(tree_leaves(restored), state)):
            raise AssertionError("ckpt: the restored step-10 state != the "
                                 "trainer's")
        size = sum(x.numel() * x.element_size() for x in state)
        dtypes = sorted({str(x.dtype) for x in state})
        print(f"[10 ckpt] adamw state of {arch} ({len(state)} leaves, "
              f"{size / 2**30:.2f} GiB, {dtypes}): the step-{2 * half} "
              f"checkpoint restores to the trainer's final state bit for "
              f"bit; resumed at step {half}, the run's losses and final "
              f"state == the uninterrupted run's bit for bit "
              f"(torch.use_deterministic_algorithms); save "
              f"{[round(x, 1) for x in full['ckpt_save_s']]} s, restore "
              f"{restore_s:.1f} s host wall; trainer runs {full_s:.1f} s "
              f"(10 steps, 2 saves) and {resumed_s:.1f} s (restore, 5 "
              f"steps) ({smi})")
        del full, restored, state
        shutil.rmtree(work, ignore_errors=True)

        # ---- (c) serve: prefill 4 x 128, greedy decode 32 ------------------
        Bq, P, G = 4, 128, 32
        gen = tserve.main(["--arch", arch, "--batch", str(Bq),
                           "--prompt-len", str(P), "--gen", str(G)])
        params = ttf.init_model(0, cfg, device=dev)
        tokens, _ = tserve.prompts(cfg, Bq, P, 0, dev)
        ids, step_logits, t_pre, t_dec = tserve.greedy_generate(
            params, cfg, tokens, G)
        # Teacher-forced: one forward over the prompt and the generated
        # prefix; its logits at positions P-1 .. P+G-2 are the ones each
        # decode step produced.  bfloat16 tolerance: 16 bfloat16 eps
        # (2^-8) of the largest |logit| of the step.
        with torch.no_grad():
            full_logits, _ = ttf.forward(
                params, cfg, torch.cat([tokens, ids[:, :-1].to(
                    tokens.dtype)], dim=1))
        ref = full_logits[:, P - 1:].float()
        got = torch.stack(step_logits, dim=1).float()
        rel = float(((got - ref).abs().amax(dim=(0, 2))
                     / ref.abs().amax(dim=(0, 2))).max())
        agree = float((torch.argmax(ref, dim=-1) == ids).float().mean())
        same = bool(np.array_equal(ids.cpu().numpy(), gen))
        tol = 16 * 2.0 ** -8
        if not (torch.isfinite(got).all() and rel <= tol
                and ids.shape == (Bq, G)):
            raise AssertionError(f"serve: decode logits {rel:.3g} of the "
                                 f"step's max |logit| from the teacher-"
                                 f"forced forward (tolerance {tol})")
        print(f"[10 serve] {arch} full width, bfloat16: prefill {Bq} x {P} "
              f"tokens {t_pre * 1e3:.1f} ms, greedy decode {G - 1} steps "
              f"{Bq * (G - 1) / t_dec:.1f} tokens/s (host wall ending in a "
              f"sync, warm); each step's logits within {rel:.3g} of the "
              f"step's max |logit| of the teacher-forced forward "
              f"(tolerance {tol:.4f}); greedy ids agree with the forward's "
              f"argmax at {agree:.1%} of positions; the driver's ids == "
              f"this run's: {same} ({smi})")
        del full_logits, ref, got, step_logits

        # Where the time goes: one traced decode step and one traced adamw
        # step at the shapes above.
        with torch.no_grad():
            _, caches = ttf.prefill(params, cfg, tokens, P + G)
            _profile(torch, f"decode step, batch {Bq} at position {P}",
                     lambda: ttf.decode_step(params, cfg, ids[:, :1], caches,
                                             P), tag="10 profile")
        del caches
        opt = adamw(lr=3e-4)
        state = [params, opt.init(params)]
        step_fn = make_train_step(cfg, opt, remat=False)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticTokens(
            cfg.vocab_size, S, seed=0).batch(0, 0, B).items()}

        def train_step():
            state[0], state[1], _ = step_fn(state[0], state[1], batch)
        _profile(torch, f"adamw train step, batch {B} x seq {S}",
                 train_step, tag="10 profile")
        del params, state, batch
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"[10 counts] launches in phase 10: {launches}")
    for name in ("sturm_bisect_tree", "sturm_count_newton"):
        if launches[name] == 0:
            raise AssertionError(f"phase 10: {name} never launched")
    print(f"[10 time] phase 10 took {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    return launches


def _stebz_at(d, e, idx):
    """scipy's bisection driver (stebz) at the eigenvalue indices ``idx``
    (runs in a worker process).  Returns (the eigenvalues, the seconds
    the worker took)."""
    import numpy as np
    import scipy.linalg as sla
    t0 = time.perf_counter()
    lam = np.array([sla.eigh_tridiagonal(
        d, e, eigvals_only=True, select="i", select_range=(int(k), int(k)),
        lapack_driver="stebz")[0] for k in idx])
    return lam, time.perf_counter() - t0


def _sturm_below(d, e, shifts):
    """The number of eigenvalues of T = tridiag(e, d, e) at or below each
    shift, by the LDL^T pivot recurrence in numpy (DSTEBZ's count: a
    pivot within pivmin of zero becomes -pivmin and counts; runs in a
    worker process).  A reference of its own, independent of the port's
    Sturm kernels.  The glued Wilkinson matrices repeat one block, so a
    pivot of exactly zero recurs in every block: counting it before the
    floor, as ``q < 0``, miscounts by the number of blocks."""
    import numpy as np
    e2 = e * e
    pivmin = np.finfo(np.float64).tiny * max(1.0, float(e2.max(initial=0.0)))
    q = d[0] - shifts
    q = np.where(np.abs(q) < pivmin, -pivmin, q)
    count = (q <= 0).astype(np.int64)
    for k in range(1, d.shape[0]):
        q = (d[k] - shifts) - e2[k - 1] / q
        q = np.where(np.abs(q) < pivmin, -pivmin, q)
        count += q <= 0
    return count


def _secular_window_ops(kp, start, nroots, niter):
    """Operations of a root window: each active root in [start, start +
    nroots) sweeps its problem's kprime poles (``_secular_ops``'s count a
    pair)."""
    import numpy as np
    kp = kp.astype("float64")
    roots = np.clip(kp - start, 0, nroots)
    return float((roots * kp).sum()) * (18 + 6 * niter)


def _phase11(torch, np, smi, ref16):
    """Phase 11: the distributed conquer on the card, P shards on the one
    card through ``make_solver_mesh(P, devices=["cuda:0"] * P)`` (see the
    module docstring).  ``ref16`` is phase 3's (reference, eps ||T||) of
    the uniform n = 16384 problem.  Raises on any failed check; returns
    (the phase's launch counts by kernel name, the window entry's record).
    """
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core import (eigvalsh_tridiagonal, make_family,
                                  make_plan)
    from repro_torch.core import secular as sec
    from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import (secular_solve_cuda,
                                                   secular_solve_window_cuda)
    from repro_torch.kernels.sterf import sterf_cuda
    from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.kernels.zhat import zhat_reconstruct_cuda
    from repro_torch.launch.mesh import make_solver_mesh
    from repro_torch.serve import EigensolverClient
    from repro_torch.serve.engine import _host_pad

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    eps = float(np.finfo(np.float64).eps)
    meshes = {P: make_solver_mesh(P, devices=["cuda:0"] * P)
              for P in (2, 4)}
    kernels = {"resident_merge": resident_merge_cuda,
               "secular_roots": secular_solve_cuda,
               "fused_update": secular_postpass_cuda,
               "deflate_chain": deflate_chain_cuda,
               "zhat": zhat_reconstruct_cuda,
               "boundary_update": boundary_rows_update_cuda,
               "sturm_count": sturm_count_cuda,
               "sturm_count_newton": sturm_count_newton_cuda,
               "sturm_bisect_tree": sturm_bisect_tree_cuda,
               "sterf": sterf_cuda}

    def same_bits(a, b):
        view = {torch.float64: torch.int64, torch.float32: torch.int32}
        if a.dtype in view:
            a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
        return a.shape == b.shape and bool(torch.equal(a, b))

    # ---- (b)'s references run in worker processes -----------------------
    # The uniform n = 16384 problem is phase 3's (its reference is the
    # full stebz-adjudicated one).  At n = 65536 scipy's default driver
    # takes over a minute and disagrees with stebz by more than 8 eps
    # ||T|| at most indices, and a full stebz takes tens of ms an index
    # (printed below), so the other three problems are held to stebz at
    # 206 indices (both ends and every 1/192 of the spectrum) and, at
    # every index, to exact Sturm counts in numpy (``_sturm_below``,
    # independent of the port) at 64 eps ||T||_inf.  Both run on the host
    # while the card works, and are read after the launch counts.
    problems = {(fam, n): make_family(fam, n, seed=0)
                for fam in ("uniform", "glued_wilkinson")
                for n in (16384, 65536)}
    pool = ProcessPoolExecutor(max_workers=min(7, os.cpu_count() or 1),
                               mp_context=mp.get_context("spawn"))
    samples, sturm = {}, {}
    try:
        for key, (d, e) in problems.items():
            if key == ("uniform", 16384):
                continue
            n = key[1]
            idx = np.unique(np.concatenate([
                np.arange(8), n - 8 + np.arange(8),
                np.linspace(0, n - 1, 192).astype(np.int64)]))
            samples[key] = (idx, [pool.submit(_stebz_at, d, e, part)
                                  for part in np.array_split(idx, 6)])

        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        secular_solve_window_cuda.launches = 0

        # ---- (b) uniform and glued Wilkinson, n = 16384 and 65536 -------
        results, times, peaks = {}, {}, {}
        for (fam, n), (d, e) in problems.items():
            for P in (1, 2, 4):
                mesh = 1 if P == 1 else meshes[P]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                lam = eigvalsh_tridiagonal(d, e, mesh=mesh)
                torch.cuda.synchronize()
                peaks[fam, n, P] = torch.cuda.max_memory_allocated(dev) - base
                results[fam, n, P] = lam
            for P in (2, 4):
                if not same_bits(results[fam, n, P], results[fam, n, 1]):
                    raise AssertionError(
                        f"(b) {fam} n={n}: mesh={P} differs from mesh=1")
        window_main = secular_solve_window_cuda.launches
        print(f"[11 main] (b) the 12 solves (2 families x n in 16384, "
              f"65536 x mesh 1, 2, 4) launched the root-window entry "
              f"{window_main} times")
        # Each cooperative level above the resident threshold (K > 2048)
        # solves its roots in P windows, one a shard.  The log2(P)
        # cooperative levels of an n-point solve merge to K = n 2^c / P,
        # c = 1 .. log2(P): at P = 2 the top level, at P = 4 the top two
        # (K = n / 2 and n), of both families.
        want_windows = 2 * sum(P for n in (16384, 65536) for P in (2, 4)
                               for c in range(1, P.bit_length())
                               if n * 2 ** c // P > 2048)
        if window_main != want_windows:
            raise AssertionError(f"phase 11: {window_main} window launches, "
                                 f"expected {want_windows}")
        lam1 = {}
        for (fam, n), (d, e) in problems.items():
            lam1[fam, n] = results[fam, n, 1].cpu().numpy()
            if (fam, n) == ("uniform", 16384):
                continue
            tol = 64.0 * eps * max(1.0, _tinf(d, e))
            shifts = np.concatenate([lam1[fam, n] - tol, lam1[fam, n] + tol])
            sturm[fam, n] = [pool.submit(_sturm_below, d, e, part)
                             for part in np.array_split(shifts, n // 8192)]

        # ---- (c) a padded B = 8 batch with boundary rows, n in 12000-16384
        rng = np.random.default_rng(1111)
        sizes = sorted(int(s) for s in rng.integers(12000, 16385, 8))
        rows = [make_family("normal", n, seed=n) for n in sizes]
        padded = [_host_pad(d[None], e[None], 16384) for d, e in rows]
        Dp = np.concatenate([p[0] for p in padded])
        Ep = np.concatenate([p[1] for p in padded])
        out = {P: make_plan(16384, 8, return_boundary=True,
                            mesh=1 if P == 1 else meshes[P]).execute(
                                Dp, Ep, orig_n=np.asarray(sizes))
               for P in (1, 4)}
        for a, b, name in zip(out[1][:3], out[4][:3], ("lam", "blo", "bhi")):
            if not same_bits(a, b):
                raise AssertionError(f"(c) padded batch: {name} at mesh=4 "
                                     f"differs from mesh=1")
        print(f"[11 check] (c) B=8 padded batch, n {sizes[0]}-{sizes[-1]}, "
              f"boundary rows, mesh=4: eigenvalues, blo and bhi == mesh=1 "
              f"bit for bit")

        # ---- (d) the two-pass conquer; (e) the compressed halo ----------
        d, e = problems["uniform", 16384]
        before = {k: kernels[k].launches for k in ("zhat", "boundary_update")}
        two = {P: eigvalsh_tridiagonal(d, e, fused=False,
                                       mesh=1 if P == 1 else meshes[P])
               for P in (1, 4)}
        if not same_bits(two[4], two[1]):
            raise AssertionError("(d) fused=False: mesh=4 differs from "
                                 "mesh=1")
        two_launches = {k: kernels[k].launches - v
                        for k, v in before.items()}
        if min(two_launches.values()) == 0:
            raise AssertionError(f"(d) fused=False launched {two_launches}")
        lam16 = results["uniform", 16384, 1]
        off = eigvalsh_tridiagonal(d, e, mesh=meshes[4], compress_halo=False)
        lossy = eigvalsh_tridiagonal(d, e, mesh=meshes[4], compress_halo=True)
        norm = float(np.abs(d).max() + 2.0 * np.abs(e).max())
        lossy_err = float((lossy - lam16).abs().max())
        if not same_bits(off, lam16) or not 0.0 < lossy_err <= 0.05 * norm:
            raise AssertionError(f"(e) compress_halo: off equal "
                                 f"{same_bits(off, lam16)}, on error "
                                 f"{lossy_err:.3e} (bar {0.05 * norm:.3e})")
        print(f"[11 check] (d) fused=False n=16384 mesh=4 == mesh=1 bit for "
              f"bit, launches {two_launches}; (e) compress_halo=True mesh=4: "
              f"max |error| {lossy_err:.3e} = {lossy_err / norm:.2e} ||T|| "
              f"(bar 0.05); off == mesh=1 bit for bit")

        # ---- (f) 8 served requests on the mesh=2 route ------------------
        served_probs = [make_family("uniform", 16384, seed=100 + i)
                        for i in range(8)]
        with EigensolverClient(max_batch=8, max_wait_us=20000) as client:
            futs = [client.solve_async(d_, e_, mesh=meshes[2])
                    for d_, e_ in served_probs]
            got = [f.result(timeout=600) for f in futs]
            snap = client.metrics()["buckets"]
        for (d_, e_), res in zip(served_probs, got):
            if not same_bits(res.eigenvalues,
                             eigvalsh_tridiagonal(d_, e_, mesh=meshes[2])):
                raise AssertionError("(f) a served mesh=2 result differs "
                                     "from the sync call")
        bad = {k: sum(b[k] for b in snap.values())
               for k in ("errors", "fallbacks", "retries")}
        flushes = sum(b["flushes"] for b in snap.values())
        if any(bad.values()):
            raise AssertionError(f"(f) served traffic: {bad}")
        print(f"[11 check] (f) 8 served n=16384 requests on the mesh=2 route "
              f"in {flushes} flush(es): served == sync bit for bit; {bad}")
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        launches["secular_roots_window"] = secular_solve_window_cuda.launches
        print(f"[11 counts] launches in phase 11 (b)-(f): {launches}")
        for name in ("resident_merge", "secular_roots", "fused_update",
                     "deflate_chain", "zhat", "boundary_update",
                     "secular_roots_window"):
            if launches[name] == 0:
                raise AssertionError(f"phase 11: {name} never launched")

        # ---- (b) held to the references, after the counts ---------------
        for (fam, n), (d, e) in problems.items():
            lam_h = lam1[fam, n]
            scale = eps * max(1.0, _tinf(d, e))
            if not (np.isfinite(lam_h).all() and lam_h.shape == (n,)):
                raise AssertionError(f"(b) {fam} n={n}: bad output")
            if (fam, n) == ("uniform", 16384):
                ref, rscale = ref16
                ratio = float(np.abs(lam_h - ref).max()) / rscale
                how = "the full phase-3 reference"
            else:
                idx, futs = samples[fam, n]
                got = [f.result() for f in futs]
                ref = np.concatenate([g[0] for g in got])
                per_index = sum(g[1] for g in got) / len(idx)
                counts = np.concatenate([f.result() for f in sturm[fam, n]])
                j = np.arange(n)
                certified = (counts[:n] <= j) & (counts[n:] >= j + 1)
                if not certified.all():
                    raise AssertionError(
                        f"(b) {fam} n={n}: {int((~certified).sum())} "
                        f"eigenvalues not within 64 eps ||T||_inf by numpy "
                        f"Sturm counts")
                ratio = float(np.abs(lam_h[idx] - ref).max()) / scale
                how = (f"stebz at {len(idx)} indices, {per_index * 1e3:.1f} "
                       f"ms an index on one host core (a full stebz "
                       f"{per_index * n:.0f} core-s); all {n} within 64 by "
                       f"numpy Sturm counts")
            if ratio > 64:
                raise AssertionError(f"(b) {fam} n={n}: {ratio:.2f} eps "
                                     f"||T||_inf from the reference")
            print(f"[11 check] (b) {fam} n={n}: mesh 2 and 4 == mesh 1 bit "
                  f"for bit; max error {ratio:.2f} eps ||T||_inf (bar 64; "
                  f"{how})")
    finally:
        pool.shutdown(cancel_futures=True)

    # ---- (g) times, the transition all-gather, peak memory --------------
    for (fam, n), (d, e) in problems.items():
        for P in (1, 2, 4):
            mesh = 1 if P == 1 else meshes[P]
            times[fam, n, P] = _cuda_ms(
                torch, lambda: eigvalsh_tridiagonal(d, e, mesh=mesh), reps=5)
        gathered = {P: 1 * P * (n // P) * (1 + 2) * 8 for P in (2, 4)}
        print(f"[11 time] {fam} n={n} f64: mesh=1 {times[fam, n, 1]:.2f} ms, "
              f"mesh=2 {times[fam, n, 2]:.2f} ms, mesh=4 "
              f"{times[fam, n, 4]:.2f} ms (CUDA events, median of 5; the "
              f"shards share the one card); transition all-gather "
              f"B*P*Np*(1+r)*8 = {gathered[2]} B (P=2), {gathered[4]} B "
              f"(P=4); peak device memory mesh=1 "
              f"{peaks[fam, n, 1] / 2**20:.1f} MiB, mesh=2 "
              f"{peaks[fam, n, 2] / 2**20:.1f}, mesh=4 "
              f"{peaks[fam, n, 4] / 2**20:.1f} ({smi})")

    # ---- (a) the window entry against the full launch and its plain version
    window = {}
    for B, K, nwin in ((1, 16384, 4), (8, 8192, 2)):
        kp = K - K // 8 + 3                   # deflated tail, odd kprime
        g = np.random.default_rng(K + B)
        dd = np.sort(g.standard_normal((B, K)), axis=1)
        dd[:, kp:] += 10.0
        zz = g.standard_normal((B, K))
        zz[:, kp:] = 0.0
        zz /= np.linalg.norm(zz, axis=1, keepdims=True)
        dd_t = torch.tensor(dd, device=dev)
        z2 = torch.tensor(zz * zz, device=dev)
        rho = torch.full((B,), 0.7, dtype=torch.float64, device=dev)
        kpr = torch.full((B,), kp, dtype=torch.int32, device=dev)
        fo, ft = secular_solve_cuda(dd_t, z2, rho, kpr, niter=16)
        Kw = K // nwin
        errs = []
        for w in range(nwin):
            s0 = w * Kw
            o, t = secular_solve_window_cuda(dd_t, z2, rho, kpr, s0, Kw,
                                             niter=16)
            if not (same_bits(o, fo[:, s0:s0 + Kw])
                    and same_bits(t, ft[:, s0:s0 + Kw])):
                raise AssertionError(f"(a) window [{s0}, {s0 + Kw}) of "
                                     f"B={B} K={K} differs from the full "
                                     f"launch's columns")
            (po, pt), p_ms = _cuda_once(
                torch, lambda: sec.secular_solve_window_batched(
                    dd_t, z2, rho, kpr, s0, Kw, niter=16, chunk=256))
            lam_k = sec.secular_eigenvalues(dd_t, o, t)
            lam_p = sec.secular_eigenvalues(dd_t, po, pt)
            err = float((lam_k - lam_p).abs().max())
            # The check tells a right window from a wrong one: a zeroed
            # and a sign-flipped tau both fail the bar that o, t pass.
            wrong = [float((sec.secular_eigenvalues(dd_t, o, x)
                            - lam_p).abs().max()) for x in (0 * t, -t)]
            if err > 1e-13 or min(wrong) <= 1e-13:
                raise AssertionError(f"(a) window [{s0}, {s0 + Kw}) of B={B}"
                                     f" K={K}: max_abs_err {err:.3e} (bar "
                                     f"1e-13); zeroed / flipped {wrong}")
            errs.append(err)
        s0 = Kw if nwin > 2 else 0
        w_ms = _cuda_ms(torch, lambda: secular_solve_window_cuda(
            dd_t, z2, rho, kpr, s0, Kw, niter=16), reps=5)
        f_ms = _cuda_ms(torch, lambda: secular_solve_cuda(
            dd_t, z2, rho, kpr, niter=16), reps=5)
        ops_w = _secular_window_ops(kpr.cpu().numpy(), s0, Kw, 16)
        # d and z2 read once, rho and kprime, origin and tau written once.
        nbytes = 2 * 8 * B * K + 12 * B + (4 + 8) * B * Kw
        bound, by = _bound_ms(ops_w, nbytes, "float64")
        window[B, K] = dict(ms=w_ms, full_ms=f_ms, plain_ms=p_ms,
                            max_abs_err=max(errs), bound_ms=bound,
                            bound_by=by, start=s0, nroots=Kw, kprime=kp)
        print(f"[11 window] B={B} K={K} kprime={kp}: {nwin} windows of {Kw} "
              f"== the full launch's columns bit for bit; max_abs_err vs "
              f"plain {max(errs):.3e} (bar 1e-13; a zeroed and a flipped "
              f"tau fail it); window [{s0}, {s0 + Kw}) {w_ms:.3f} ms, full "
              f"launch {f_ms:.3f} ms, plain window {p_ms:.1f} ms (one run), "
              f"bound {bound:.4f} ms ({by}) ({smi})")
    print(f"[11 time] phase 11 took {time.perf_counter() - t_phase:.1f} s "
          f"({smi})")
    return launches, window


# ---------------------------------------------------------------- phase 12

_P12_KERNELS = ("resident_merge", "secular_roots", "fused_update",
                "deflate_chain", "zhat", "boundary_update", "sturm_count",
                "sturm_count_newton", "sturm_bisect_tree", "sterf")
# Per-step loss and grad norm of four ranks against one (bfloat16
# parameters and activations; the ranks reduce partial sums in another
# order and round them to bfloat16): 8 bfloat16 eps relative.
_P12_BF16_BOUND = 8 * 2.0 ** -8
_P12_ARGS = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "256",
             "--log-every", "100", "--steps", "6", "--spectral-every", "2",
             "--serve-monitor", "--probe-steps", "4", "--probe-batch", "1",
             "--target-sharpness", "20", "--ckpt-every", "4"]


def _p12_kernels():
    from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
    from repro_torch.kernels.deflate_chain import deflate_chain_cuda
    from repro_torch.kernels.fused_update import secular_postpass_cuda
    from repro_torch.kernels.resident_merge import resident_merge_cuda
    from repro_torch.kernels.secular_roots import secular_solve_cuda
    from repro_torch.kernels.sterf import sterf_cuda
    from repro_torch.kernels.sturm_count import (sturm_bisect_tree_cuda,
                                                 sturm_count_cuda,
                                                 sturm_count_newton_cuda)
    from repro_torch.kernels.zhat import zhat_reconstruct_cuda
    return dict(zip(_P12_KERNELS, (
        resident_merge_cuda, secular_solve_cuda, secular_postpass_cuda,
        deflate_chain_cuda, zhat_reconstruct_cuda, boundary_rows_update_cuda,
        sturm_count_cuda, sturm_count_newton_cuda, sturm_bisect_tree_cuda,
        sterf_cuda)))


def _p12_share(tree, mesh):
    """(local bytes, the rules' exact share in bytes, the whole's bytes)
    of a DTensor tree."""
    from repro_torch.tree import tree_leaves
    names = mesh.mesh_dim_names
    local = share = whole = 0
    for x in tree_leaves(tree):
        div = 1
        for name, pl in zip(names, x.placements):
            if pl.is_shard():
                div *= mesh.size(names.index(name))
        n = x.numel()
        if n % div:
            raise AssertionError(f"{tuple(x.shape)} does not split {div} ways")
        share += n // div * x.element_size()
        whole += n * x.element_size()
        local += x.to_local().numel() * x.element_size()
    return local, share, whole


def _p12_batches(torch, cfg, steps, dev):
    from repro_torch.data import SyntheticTokens
    src = SyntheticTokens(cfg.vocab_size, 256, seed=0)
    return [{k: torch.from_numpy(v).to(dev) for k, v in
             src.batch(s, 0, 8).items()} for s in range(steps)]


def _p12_rank(rank, world, store, work, job, queue):
    """A phase-12 rank: ``job`` "train" runs (a), (c) and (d) on four ranks,
    "restore" (e)'s two-rank restore."""
    import datetime
    import traceback
    sys.path[:0] = [os.path.join(HERE, "src")]
    os.environ["LOCAL_RANK"] = "0"
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=600))
        # Ranks sharing the card: DTensor's collectives through host
        # memory (launch.train installs it too, for its own group).
        from repro_torch.dist import host_staged
        host_staged.install()
        out = (_p12_train(torch, rank, work) if job == "train"
               else _p12_restore(torch, rank, work))
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _p12_train(torch, rank, work):
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.dist import host_staged
    from repro_torch.dist import sharding as sh
    from repro_torch.dist.compression import (_QMAX, CompressionState,
                                              compressed_cross_pod_mean,
                                              init_compression_state)
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.pipeline import (make_pipelined_train_step,
                                             stage_shardings)
    from repro_torch.launch.steps import (_pod_view, loss_and_grads,
                                          make_train_step,
                                          make_train_step_compressed)
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", 0)
    kernels = _p12_kernels()
    out = {}
    # ---- (a) the trainer on four ranks, mesh (data 2, model 2) ----------
    for k in kernels.values():
        k.launches = 0
    host_staged.reset_staged_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hook_s = [0.0]

    def keep(step, params, batch):
        # Each step's starting parameters, gathered, for the one-rank
        # check at the same parameters (rank 0 writes them).
        th = time.perf_counter()
        full = tree_map(lambda x: x.full_tensor(), params)
        if rank == 0:
            torch.save({"params": full, "batch": batch},
                       os.path.join(work, f"p12_step{step}.pt"))
        del full
        hook_s[0] += time.perf_counter() - th

    rep = ttrain.main(_P12_ARGS + ["--devices", "4", "--model-parallel", "2",
                                   "--ckpt-dir", os.path.join(work, "a")],
                      before_step=keep)
    out["a_s"] = time.perf_counter() - t0 - hook_s[0]
    out["hook_s"] = hook_s[0]
    out["launches"] = {n: k.launches for n, k in kernels.items()}
    out["staged"] = host_staged.staged_counts()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    params, state = rep["state"]
    mesh = tree_leaves(params)[0].device_mesh
    out["state_bytes"] = _p12_share((params, state), mesh)
    for key in ("losses", "grad_norms", "lr_scales", "step_event_ms",
                "mesh", "probes", "lam_max"):
        out[key] = rep[key]
    # One more step under CommDebugMode: its collectives and the bytes the
    # host staging carried for them.
    cfg = get_config("qwen3-0.6b")
    opt = adamw(lr=3e-4)
    step = make_train_step(cfg, opt, remat=False)
    batch = _p12_batches(torch, cfg, 1, dev)[0]
    sh.set_activation_mesh(mesh)
    host_staged.reset_staged_counts()
    comm = CommDebugMode()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with comm:
        ev[0].record()
        step(params, state, sh.distribute_tree(batch, {
            k: sh.batch_sharding(mesh, 8, 2) for k in batch}))
        ev[1].record()
    torch.cuda.synchronize()
    sh.set_activation_mesh(None)
    out["comm"] = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    out["comm_staged"] = host_staged.staged_counts()
    out["comm_step_ms"] = ev[0].elapsed_time(ev[1])
    del rep, params, state
    import gc
    gc.collect()
    torch.cuda.empty_cache()    # the ranks share the card's memory

    # ---- (c) the int8 compressed step, (pod 2, data 1, model 2) ----------
    params = tf.init_model(0, cfg, device=dev)
    state = opt.init(params)
    batches = _p12_batches(torch, cfg, 2, dev)
    cmesh = make_mesh_for(4, model_parallel=2, pods=2, device_type="cuda")
    inner = cmesh[("data", "model")]
    pods = cmesh.get_group("pod")
    sh.set_activation_mesh(cmesh)
    try:
        p_sh = sh.param_shardings(params, cmesh)
        P, S = sh.distribute_tree((params, state), (
            p_sh, sh.opt_shardings(state, params, p_sh, cmesh)))
        del params, state   # the ranks share the card: keep shards only
        err = init_compression_state(
            tree_map(lambda p: _pod_view(p, inner), P)).error
        cstep = make_train_step_compressed(cfg, opt, cmesh, remat=True)
        closs, cms, gap = [], [], 0.0
        for i, b in enumerate(batches):
            B = sh.distribute_tree(b, {k: sh.batch_sharding(cmesh, 8, 2)
                                       for k in b})
            if i == 0:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                lb = {k: _pod_view(v, inner) for k, v in B.items()}
                sh.set_manual_axes({"pod"})
                try:
                    with implicit_replication():
                        _, _, g = loss_and_grads(
                            lambda p: tf.loss_fn(p, cfg, lb),
                            tree_map(lambda p: _pod_view(p, inner), P))
                        mean, new = compressed_cross_pod_mean(
                            g, CompressionState(err), pods)
                        for a, e, w in zip(tree_leaves(mean),
                                           tree_leaves(new.error),
                                           tree_leaves(g)):
                            w32 = w.to(torch.float32)
                            scale = torch.clamp_min(
                                torch.amax(torch.abs(w32)) / _QMAX,
                                torch.finfo(torch.float32).tiny)
                            deq = torch.clamp(torch.round(w32 / scale),
                                              -_QMAX, _QMAX) * scale
                            deq, e, w32, a = (x.to_local() for x in
                                              (deq, e, w32, a))
                            top = float(w32.abs().max()) or 1.0
                            gap = max(gap, float((deq + e - w32).abs().max())
                                      / top)
                            avg = deq.clone()
                            dist.all_reduce(avg, group=pods)
                            avg = avg / dist.get_world_size(pods)
                            # the mean comes back in the gradient's dtype
                            gap = max(gap, float((a.to(torch.float32) - avg.to(
                                a.dtype).to(torch.float32)).abs().max()))
                        del g, mean, new
                finally:
                    sh.set_manual_axes(set())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            P, S, m, err = cstep(P, S, B, err, 1.0)
            ev[1].record()
            closs.append(float(m["loss"]))
            torch.cuda.synchronize()
            cms.append(ev[0].elapsed_time(ev[1]))
        out["c"] = dict(losses=closs, gap=gap, ms=cms)
    finally:
        sh.set_activation_mesh(None)
    del P, S, err
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the pipelined step, (pod 2, data 2, model 1), n_micro 4 -----
    pmesh = make_mesh_for(4, model_parallel=1, pods=2, device_type="cuda")
    sh.set_activation_mesh(pmesh)
    try:
        params = tf.init_model(0, cfg, device=dev)
        state = opt.init(params)
        p_sh = stage_shardings(sh.param_shardings(params, pmesh), params,
                               cfg, pmesh)
        P, S = sh.distribute_tree((params, state), (
            p_sh, sh.opt_shardings(state, params, p_sh, pmesh)))
        del params, state
        pstep = make_pipelined_train_step(cfg, opt, n_stages=2, n_micro=4,
                                          remat=True, mesh=pmesh)
        B = sh.distribute_tree(batches[0], {
            k: sh.sharding(pmesh, ("data", None)) for k in batches[0]})
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        P, S, m = pstep(P, S, B, 1.0)
        ev[1].record()
        out["d"] = dict(loss=float(m["loss"]), grad_norm=float(
            m["grad_norm"]))
        torch.cuda.synchronize()
        out["d"]["ms"] = ev[0].elapsed_time(ev[1])
    finally:
        sh.set_activation_mesh(None)
    out["peak_all"] = torch.cuda.max_memory_allocated(dev)
    return out


def _p12_crcs(torch, tree):
    """CRC32 of each leaf's bytes (a DTensor gathered whole), in the
    checkpoint's flattening order."""
    import zlib

    from repro_torch.checkpoint.manager import _flatten_with_paths
    out = {}
    for key, x in _flatten_with_paths(tree):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        t = x.detach().contiguous().reshape(-1).cpu()
        out[key] = zlib.crc32(t.view(torch.uint8).numpy()) & 0xFFFFFFFF
    return out


def _p12_like(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    params = tf.init_model(1, get_config("qwen3-0.6b"), device=dev)
    return params, adamw(lr=3e-4).init(params)


def _p12_restore(torch, rank, work):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    dev = torch.device("cuda", 0)
    params, state = _p12_like(torch, dev)
    mesh = make_mesh_for(2, model_parallel=2, device_type="cuda")
    p_sh = sh.param_shardings(params, mesh)
    shardings = (p_sh, sh.opt_shardings(state, params, p_sh, mesh))
    t0 = time.perf_counter()
    tree, _, step = CheckpointManager(os.path.join(work, "a")).resume(
        (params, state), shardings=shardings)
    restore_s = time.perf_counter() - t0
    del params, state
    local, share, _ = _p12_share(tree, mesh)
    return dict(step=step, crcs=_p12_crcs(torch, tree), restore_s=restore_s,
                mesh=str(tuple(mesh.mesh_dim_names)) + str(tuple(mesh.shape)),
                local=local, share=share)


def _p12_spawn(world, job, store, work):
    """Start ``world`` rank processes; :func:`_p12_collect` waits for
    them (this process works on the card meanwhile)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_p12_rank,
                         args=(r, world, store, work, job, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    return job, procs, queue


def _p12_collect(started, timeout):
    job, procs, queue = started
    results = {}
    try:
        for _ in procs:
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise AssertionError(f"phase 12 {job} rank {rank}:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return results


def _phase12(torch, np, smi):
    """Phase 12: the multi-rank trainer on the card (see the module
    docstring).  Raises on any failed check; returns the phase's launch
    counts by kernel name (the four ranks of (a), summed)."""
    import datetime
    import json as _json
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    bound = _P12_BF16_BOUND
    torch.cuda.empty_cache()    # four more processes share the card
    print(f"[12 memory] this process holds "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB of the card "
          f"as phase 12 starts ({smi})")
    work = tempfile.mkdtemp(prefix="repro-torch-phase12-")
    try:
        # ---- (a), (c), (d) on four ranks sharing the card ----------------
        t0 = time.perf_counter()
        ranks = _p12_collect(_p12_spawn(4, "train", os.path.join(
            work, "store4"), work), 900)
        ranks_s = time.perf_counter() - t0
        r0 = ranks[0]
        launches = {n: sum(r["launches"][n] for r in ranks.values())
                    for n in _P12_KERNELS}
        # Each step on one rank, in this process, from the parameters and
        # batch that step of (a) started from: (a)'s loss and grad norm
        # against the one-device step's on the same inputs.
        cfg = get_config("qwen3-0.6b")
        ref_step = make_train_step(cfg, adamw(lr=3e-4), remat=False)
        one = {"losses": [], "grad_norms": [], "ms": []}
        t0 = time.perf_counter()
        for k in range(6):
            saved = torch.load(os.path.join(work, f"p12_step{k}.pt"),
                               map_location=dev)
            params = saved["params"]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            _, _, m = ref_step(params, adamw(lr=3e-4).init(params),
                               saved["batch"], 1.0)
            ev[1].record()
            one["losses"].append(float(m["loss"]))
            one["grad_norms"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            one["ms"].append(ev[0].elapsed_time(ev[1]))
            del saved, params, m
        one_s = time.perf_counter() - t0
        rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
        err_l = rel(r0["losses"], one["losses"])
        err_g = rel(r0["grad_norms"], one["grad_norms"])
        if len(r0["losses"]) != 6 or err_l > bound or err_g > bound:
            raise AssertionError(
                f"(a) four ranks {r0['losses']} / {r0['grad_norms']} vs one "
                f"rank at the same parameters {one['losses']} / "
                f"{one['grad_norms']}: {err_l:.3e} / {err_g:.3e} (bound "
                f"{bound:.3e})")
        scales = {tuple(r["lr_scales"]) for r in ranks.values()}
        if len(scales) != 1 or min(r0["lr_scales"]) >= 1.0:
            raise AssertionError(f"(a) lr_scales differ or never damped: "
                                 f"{scales}")
        for name in ("sturm_bisect_tree", "sturm_count_newton"):
            if launches[name] == 0:
                raise AssertionError(f"(a) {name} never launched")
        for rank, r in sorted(ranks.items()):
            local, share, full = r["state_bytes"]
            if local != share:
                raise AssertionError(f"(a) rank {rank} holds {local} bytes "
                                     f"of parameters and optimizer state, "
                                     f"the rules' share is {share}")
        step_ms = statistics.median(r0["step_event_ms"][1:])
        one_ms = statistics.median(one["ms"][1:])
        print(f"[12 train] qwen3-0.6b full width bfloat16, {r0['mesh']} on "
              f"4 gloo ranks sharing cuda:0, adamw, batch 8 x seq 256, 6 "
              f"steps, a served probe every 2: losses {r0['losses']} vs one "
              f"rank from the same parameters and batch {one['losses']}; "
              f"max rel err loss {err_l:.3e}, "
              f"grad_norm {err_g:.3e} (bound 8 bf16 eps = {bound:.3e}); "
              f"lr_scales {r0['lr_scales']} on every rank; probes "
              f"{r0['probes']}, lam_max {r0['lam_max']:.6g} ({smi})")
        print(f"[12 time] step {step_ms:.1f} ms on four ranks (CUDA "
              f"events on rank 0, median of steps 2-6) vs {one_ms:.1f} ms "
              f"on one (the same steps, from the same parameters, median "
              f"of steps 2-6); (a) {r0['a_s']:.1f} s host wall on rank 0 "
              f"(beside {r0['hook_s']:.1f} s gathering and saving each "
              f"step's parameters for the check), the one-rank steps "
              f"{one_s:.1f} s ({smi})")
        for rank, r in sorted(ranks.items()):
            local, share, full = r["state_bytes"]
            print(f"[12 memory] rank {rank}: parameters + adamw state "
                  f"{local} B == the rules' share ({share} B; the whole is "
                  f"{full} B, {full / local:.2f}x); peak device memory "
                  f"(a) {r['peak'] / 2**30:.2f} GiB, whole phase "
                  f"{r['peak_all'] / 2**30:.2f} GiB ({smi})")
        print(f"[12 comm] one more step on (data 2, model 2): "
              f"{r0['comm_step_ms']:.1f} ms (CUDA events); CommDebugMode "
              f"counts {r0['comm']}; staged through host memory "
              f"(calls, bytes) {r0['comm_staged']}; over (a) on rank 0 "
              f"{r0['staged']} ({smi})")
        print(f"[12 counts] launches in phase 12 (a), four ranks: "
              f"{launches}")

        # ---- (c) compressed, (d) pipelined ------------------------------
        c, d = r0["c"], r0["d"]
        if (abs(c["losses"][0] - one["losses"][0]) > bound * abs(
                one["losses"][0]) or abs(c["losses"][1] - one["losses"][1])
                > 1e-2 * abs(one["losses"][1]) or c["gap"] > 1e-6):
            raise AssertionError(f"(c) compressed losses {c['losses']} vs "
                                 f"{one['losses'][:2]}; payload gap "
                                 f"{c['gap']:.3e}")
        print(f"[12 compressed] (pod 2, data 1, model 2), int8 cross-pod "
              f"mean: losses {c['losses']} vs uncompressed one-rank "
              f"{one['losses'][:2]} (step 0 bound {bound:.3e}, step 1 "
              f"1e-2 relative); payload + residual == float32 gradient, "
              f"mean == pod average: max rel gap {c['gap']:.3e} (bar 1e-6);"
              f" step {c['ms'][1]:.1f} ms ({smi})")
        if abs(d["loss"] - one["losses"][0]) > bound * abs(one["losses"][0]):
            raise AssertionError(f"(d) pipelined loss {d['loss']} vs "
                                 f"{one['losses'][0]}")
        print(f"[12 pipeline] (pod 2, data 2, model 1), 2 stages, n_micro "
              f"4: step-0 loss {d['loss']:.6g} vs one-rank "
              f"{one['losses'][0]:.6g} (bound {bound:.3e} relative); step "
              f"{d['ms']:.1f} ms ({smi})")

        # ---- (e)'s two ranks start; (b) and (e)'s one rank run here -----
        torch.cuda.empty_cache()
        started = _p12_spawn(2, "restore", os.path.join(work, "store2"),
                             work)

        # ---- (b) world size 1 on NCCL, mesh (1, 1) ----------------------
        opt = adamw(lr=3e-4)
        batch = _p12_batches(torch, cfg, 1, dev)[0]
        params = tf.init_model(0, cfg, device=dev)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=False)
        p1, s1, m1 = step(params, state, batch, 1.0)
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(work, 'store1')}",
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_mesh_for(1, device_type="cuda")
            sh.set_activation_mesh(mesh)
            p_sh = sh.param_shardings(params, mesh)
            P, S, B = sh.distribute_tree((params, state, batch), (
                p_sh, sh.opt_shardings(state, params, p_sh, mesh),
                {k: sh.batch_sharding(mesh, 8, 2) for k in batch}))
            p2, s2, m2 = step(P, S, B, 1.0)
            same = all(
                torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                            else a, (b.full_tensor().view(torch.int16)
                                     if b.dtype == torch.bfloat16
                                     else b.full_tensor()))
                for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))))
            same_m = all(torch.equal(m1[k], m2[k]) for k in ("loss",
                                                              "grad_norm"))
        finally:
            sh.set_activation_mesh(None)
            dist.destroy_process_group()
        if not (same and same_m):
            raise AssertionError(
                f"(b) mesh (1, 1) step != one-device step: state "
                f"{same}, metrics {same_m} ({float(m1['loss'])!r} vs "
                f"{float(m2['loss'])!r})")
        print(f"[12 nccl] world size 1 on NCCL, {mesh.mesh_dim_names} "
              f"{tuple(mesh.shape)}: one step on DTensors == the one-device "
              f"step bit for bit (parameters, adamw state, loss "
              f"{float(m1['loss'])!r}, grad norm {float(m1['grad_norm'])!r})")
        del p1, s1, p2, s2, P, S, params, state

        # ---- (e) reshard-on-load of (a)'s step-4 checkpoint --------------
        from repro_torch.checkpoint import CheckpointManager
        with open(os.path.join(work, "a", "step_00000004",
                               "manifest.json")) as f:
            manifest = _json.load(f)
        want = {k: v["crc32"] for k, v in manifest["leaves"].items()}
        like = _p12_like(torch, dev)
        t0 = time.perf_counter()
        tree, _, got_step = CheckpointManager(os.path.join(work, "a")).resume(
            like)
        one_restore_s = time.perf_counter() - t0
        if got_step != 4 or _p12_crcs(torch, tree) != want:
            raise AssertionError(f"(e) one-rank restore of step {got_step} "
                                 f"differs from the saved arrays")
        del tree, like
        two = _p12_collect(started, 600)
        for rank, r in sorted(two.items()):
            if r["step"] != 4 or r["crcs"] != want or r["local"] != r["share"]:
                raise AssertionError(f"(e) rank {rank} of {r['mesh']}: "
                                     f"step {r['step']}, shard {r['local']} "
                                     f"B vs {r['share']} B, CRCs equal "
                                     f"{r['crcs'] == want}")
        print(f"[12 reshard] (a)'s step-4 checkpoint ({len(want)} leaves) "
              f"restored onto one rank ({one_restore_s:.1f} s) and onto "
              f"{two[0]['mesh']} (two ranks, {two[0]['restore_s']:.1f} s): "
              f"every leaf == the saved array bit for bit (CRC32); each "
              f"rank holds its share ({two[0]['local']} B) ({smi})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[12 time] phase 12 took {time.perf_counter() - t_phase:.1f} s "
          f"(the four-rank spawn {ranks_s:.1f} s) ({smi})")
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

    # ---- phase 10: the trainer and the serving driver at full width -----
    phase10_launches = _phase10(torch, np, smi)

    # ---- phase 11: the distributed conquer, P shards on the card --------
    phase11_launches, window11 = _phase11(torch, np, smi, refs["u16"])

    # ---- phase 12: the multi-rank trainer, four ranks on the card -------
    phase12_launches = _phase12(torch, np, smi)

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
    for rec in out:   # phases 8-10's own counts, beside the main path's
        rec["serve_launches"] = int(serve_launches.get(rec["name"], 0))
        rec["phase9_launches"] = int(phase9_launches.get(rec["name"], 0))
        rec["phase10_launches"] = int(phase10_launches.get(rec["name"], 0))
        rec["phase11_launches"] = int(phase11_launches[rec["name"]])
        rec["phase12_launches"] = int(phase12_launches[rec["name"]])
    w16, w8 = window11[1, 16384], window11[8, 8192]
    roots_rec = next(r for r in out if r["name"] == "secular_roots")
    roots_rec.update(   # row 2's root-window entry (the distributed conquer)
        window_launches=int(phase11_launches["secular_roots_window"]),
        window_shape=f"B=1 K=16384 kprime={w16['kprime']} f64, roots "
                     f"[{w16['start']}, {w16['start'] + w16['nroots']})",
        window_ms=w16["ms"], window_full_ms=w16["full_ms"],
        window_plain_ms=w16["plain_ms"], window_bound_ms=w16["bound_ms"],
        window_bound_by=w16["bound_by"],
        window_max_abs_err=max(w16["max_abs_err"], w8["max_abs_err"]),
        window_b8_shape=f"B=8 K=8192 kprime={w8['kprime']} f64, roots "
                        f"[{w8['start']}, {w8['start'] + w8['nroots']})",
        window_b8_ms=w8["ms"], window_b8_full_ms=w8["full_ms"],
        window_b8_plain_ms=w8["plain_ms"], window_b8_bound_ms=w8["bound_ms"])
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
