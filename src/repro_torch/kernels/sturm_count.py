"""Batched Sturm counts on the card: wrapper of ``csrc/sturm_count.cu``
(replaces the Pallas TPU kernel
``repro.kernels.sturm_count.sturm_count_pallas_batch``).

Three launches from one source:

  * :func:`sturm_count_cuda` -- #{eigenvalues <= shift} for every
    (problem, shift); plain version ``core.bisect.sturm_count_plain``;
  * :func:`sturm_count_newton_cuda` -- the same sweep plus the derivative
    sum of the pivot recurrence; plain version
    ``core.bisect._count_and_newton``.  The JAX package runs this sweep
    as an XLA scan; in eager PyTorch it would be a Python loop of about
    ten launches per matrix row, so it is a kernel here;
  * :func:`sturm_bisect_tree_cuda` -- up to eight halvings of every
    bisection bracket in one launch: the whole bisection tree of each
    bracket counted at once, then walked with the host loop's rule;
    plain version ``core.bisect.bisect_tree_plain``.

:func:`chain_probe_cuda` is a measurement, not a step of any solve: one
thread walks one shift's chain, and its time is the latency bound of a
bisection trip.

The rows are staged through shared memory as (d, e2) pairs; every chain
has a thread of its own, and the Newton sweep gives each shift two
threads where few shifts leave the card idle (:func:`launch_shape`); see
the source for the design.  On a CPU tensor ``kernels.ops`` runs the plain
versions; on a CUDA tensor it launches these kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# Most threads a block; must equal MAX_THREADS in the source.
MAX_THREADS = 256
# Deepest bisection tree one launch counts (2^8 - 1 = 255 node chains, one
# block); must equal MAX_DEPTH in the source.
MAX_DEPTH = 8
# Shifts the split Newton kernel takes a block; must equal SPLIT_SHIFTS
# in the source.
SPLIT_SHIFTS = 64
# Shifts an SM below which the Newton sweep gives each shift two threads.
# Measured on an H100 (132 SMs) at B = 64 x 4096 with S = 16 ... 8192
# shifts a problem and at B = 1, n = 16384 with S = 64 and 32768
# (scripts/time_merge_kernels.py --kernels sturm --sweep): two threads a
# shift were faster up to S = 256 (124 an SM), one from S = 384 (186).
NEWTON_SPLIT_BELOW = 128

_DTYPE = {torch.float64: "f64", torch.float32: "f32"}


def launch_shape(B: int, S: int, sms: int, newton: bool = False,
                 split: bool | None = None) -> tuple[bool, int]:
    """(split, threads a block) of a count (or, with ``newton``, count +
    derivative) sweep of B x S shifts on a card of ``sms`` SMs
    (``split``, if given, fixes the first).

    Every shift's chain has a thread of its own.  The Newton sweep walks
    two dependent chains a shift (q and r = q'/q): where few shifts leave
    the card idle (a range solve's polish, small refine sweeps) each
    shift gets two threads (``split``), so the two run side by side;
    from NEWTON_SPLIT_BELOW shifts an SM one thread walks both.  A block
    is one to eight warps, as many as the problem's shifts need (the
    split kernel's is fixed: two threads for each of SPLIT_SHIFTS
    shifts).
    """
    if split is None:
        split = newton and B * S < NEWTON_SPLIT_BELOW * sms
    if split and not newton:
        raise ValueError("only the Newton sweep splits a shift over two "
                         "threads")
    if split:
        return True, 2 * SPLIT_SHIFTS
    return False, min(MAX_THREADS, max(32, -(-S // 32) * 32))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _entry(name: str, dtype, argtypes):
    lib = _build.load("sturm_count")
    fn = getattr(lib, f"{name}_{_DTYPE[dtype]}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, name: str, newton: bool, d, e2, shifts, pivmin,
            split=None):
    """Check the operands and launch one count (``newton``: count +
    derivative) sweep; ``split`` overrides :func:`launch_shape`'s pick,
    for the timing script's crossover sweep only -- the results do not
    depend on it."""
    _build.check_operands(d, e2, shifts, pivmin)
    B, n = d.shape
    S = shifts.shape[1] if shifts.ndim == 2 else -1
    if (e2.shape != (B, max(n - 1, 0)) or shifts.shape != (B, S)
            or pivmin.shape != (B,)):
        raise ValueError(f"shapes d {tuple(d.shape)}, e2 {tuple(e2.shape)}, "
                         f"shifts {tuple(shifts.shape)}, pivmin "
                         f"{tuple(pivmin.shape)} do not match (B, n), "
                         f"(B, n-1), (B, S), (B,)")
    if any(t.dtype != d.dtype for t in (e2, shifts, pivmin)):
        raise TypeError("e2, shifts and pivmin must have d's dtype")
    if n < 1:
        raise ValueError("a Sturm count needs n >= 1")
    count = torch.empty((B, S), dtype=torch.int32, device=d.device)
    deriv = (torch.empty((B, S), dtype=d.dtype, device=d.device)
             if newton else None)
    if B == 0 or S == 0:
        return count, deriv
    split, threads = launch_shape(B, S, _sms(d.device.index or 0), newton,
                                  split)
    blocks = B * -(-S // (SPLIT_SHIFTS if split else threads))
    if blocks > 2**31 - 1:
        raise ValueError(f"{blocks} blocks exceed one launch's grid")
    fn = _entry(name, d.dtype, [ctypes.c_void_p] * (6 if newton else 5)
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    outs = [count] + ([deriv] if newton else [])
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e2), _build.ptr(shifts),
                 _build.ptr(pivmin), *map(_build.ptr, outs), B, n, S,
                 int(split), threads, _build.stream_ptr(d.device))
    _build.check(err, name)
    wrapper.launches += 1
    return count, deriv


def sturm_count_cuda(d, e2, shifts, pivmin):
    """Launch the count kernel: d (B, n); e2 (B, n-1); shifts (B, S);
    pivmin (B,), all of one float dtype on one card.  Returns (B, S)
    int32 counts of eigenvalues <= shift."""
    return _launch(sturm_count_cuda, "sturm_count", False, d, e2, shifts,
                   pivmin)[0]


def sturm_count_newton_cuda(d, e2, shifts, pivmin):
    """Launch the count + derivative kernel (shapes as
    :func:`sturm_count_cuda`).  Returns (count (B, S) int32, s (B, S))
    with s = d/dx log|det(T - xI)| at each shift."""
    return _launch(sturm_count_newton_cuda, "sturm_count_newton", True, d,
                   e2, shifts, pivmin)


def sturm_bisect_tree_cuda(d, e2, pivmin, tol, targets, lo, hi, *,
                           depth: int, steps: int):
    """Launch one bisection tree trip: d (B, n); e2 (B, n-1); pivmin,
    tol (B,); targets (B, k) int32; lo, hi (B, k), of one float dtype on
    one card.  Counts the 2^depth - 1 midpoints of each bracket's
    bisection tree and walks ``steps`` <= depth halvings of it with the
    host loop's rule.  Returns (lo, hi, counts (B, k, 2^depth - 1) int32
    in heap order), equal bit for bit to ``steps`` trips of the loop."""
    _build.check_operands(d, e2, pivmin, tol, targets, lo, hi)
    B, n = d.shape
    k = targets.shape[1] if targets.ndim == 2 else -1
    if (e2.shape != (B, max(n - 1, 0)) or pivmin.shape != (B,)
            or tol.shape != (B,) or targets.shape != (B, k)
            or lo.shape != (B, k) or hi.shape != (B, k)):
        raise ValueError(f"shapes d {tuple(d.shape)}, e2 {tuple(e2.shape)}, "
                         f"pivmin {tuple(pivmin.shape)}, tol "
                         f"{tuple(tol.shape)}, targets "
                         f"{tuple(targets.shape)}, lo {tuple(lo.shape)}, hi "
                         f"{tuple(hi.shape)} do not match (B, n), (B, n-1), "
                         f"(B,), (B,), (B, k), (B, k), (B, k)")
    if any(t.dtype != d.dtype for t in (e2, pivmin, tol, lo, hi)):
        raise TypeError("e2, pivmin, tol, lo and hi must have d's dtype")
    if targets.dtype != torch.int32:
        raise TypeError(f"targets must be int32, got {targets.dtype}")
    if n < 1:
        raise ValueError("a Sturm count needs n >= 1")
    if not (1 <= depth <= MAX_DEPTH and 0 <= steps <= depth):
        raise ValueError(f"need 1 <= depth <= {MAX_DEPTH} and 0 <= steps "
                         f"<= depth, got depth {depth}, steps {steps}")
    nodes = 2 ** depth - 1
    lo_out = torch.empty_like(lo)
    hi_out = torch.empty_like(hi)
    counts = torch.empty((B, k, nodes), dtype=torch.int32, device=d.device)
    if B == 0 or k == 0:
        return lo_out, hi_out, counts
    blocks = B * -(-k // (MAX_THREADS // nodes))
    if blocks > 2**31 - 1:
        raise ValueError(f"{blocks} blocks exceed one launch's grid")
    fn = _entry("sturm_bisect_tree", d.dtype, [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(d.device):
        err = fn(*map(_build.ptr, (d, e2, pivmin, tol, targets, lo, hi,
                                   lo_out, hi_out, counts)),
                 B, n, k, int(depth), int(steps),
                 _build.stream_ptr(d.device))
    _build.check(err, "sturm_bisect_tree")
    sturm_bisect_tree_cuda.launches += 1
    return lo_out, hi_out, counts


sturm_count_cuda.launches = 0
sturm_count_newton_cuda.launches = 0
sturm_bisect_tree_cuda.launches = 0


def chain_probe_cuda(d, e2, shift: float, pivmin: float):
    """Time one shift's chain on one thread: d (n,), e2 (n-1,) float64 on
    one card.  Returns (count, cycles) as device tensors: the Sturm count
    at ``shift`` (equal to the count kernel's) and the SM clock cycles of
    the sweep, n times the latency of one row's dependent operations."""
    _build.check_operands(d, e2)
    n = d.shape[0]
    if d.dtype != torch.float64 or e2.dtype != torch.float64:
        raise TypeError("the chain probe runs float64")
    if d.ndim != 1 or e2.shape != (max(n - 1, 0),) or n < 1:
        raise ValueError(f"shapes d {tuple(d.shape)}, e2 {tuple(e2.shape)} "
                         f"are not (n,), (n-1,) with n >= 1")
    lib = _build.load("sturm_count")
    fn = lib.sturm_chain_probe_f64
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_double] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    count = torch.empty((1,), dtype=torch.int32, device=d.device)
    cycles = torch.empty((1,), dtype=torch.int64, device=d.device)
    with torch.cuda.device(d.device):
        err = fn(_build.ptr(d), _build.ptr(e2), float(shift), float(pivmin),
                 _build.ptr(count), _build.ptr(cycles), n,
                 _build.stream_ptr(d.device))
    _build.check(err, "sturm_chain_probe")
    return count, cycles
