"""Guarded front door: input validation, overflow-safe equilibration,
and the robustness error taxonomy (port copy of ``repro.core.guard``).

  * :class:`InvalidInputError` -- structured rejection naming the
    offending field, lane and index, raised at route time.
  * :func:`validate_problem` -- shape / dtype / finiteness checks.
  * :func:`equilibrate` -- LAPACK-style norm scaling (DSTEDC's ``orgnrm``
    guard): when the problem's scale leaves the range where squared
    off-diagonals are representable, (d, e) are scaled by an exact power
    of two and eigenvalues are inverse-scaled on output.  ``scale == 1``
    traffic is returned untouched.

Inputs may be numpy arrays or torch tensors on any device; a tensor is
checked with torch reductions where it lies (one host sync each).
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.core.instrument import SolveCounter, span


class InvalidInputError(ValueError):
    """A malformed or poisoned problem, rejected at the front door."""

    def __init__(self, message: str, *, field: str | None = None,
                 lane: int | None = None, index: int | None = None):
        super().__init__(message)
        self.field = field
        self.lane = lane
        self.index = index


class DeadlineExceeded(TimeoutError):
    """A request outlived its ``deadline_ms`` budget."""


class CertificationError(RuntimeError):
    """The graceful-degradation ladder was exhausted."""


# Process-wide robustness counters (the serving layer of a later slice
# reports them).
DEGRADATIONS = SolveCounter("degradations")
DEADLINES = SolveCounter("deadline_expired")


def _is_torch_tensor(x) -> bool:
    # Avoid importing torch for plain-numpy traffic paths.
    import sys
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if _is_torch_tensor(x) else np.asarray(x)


def _first_nonfinite(arr: np.ndarray):
    """(lane, index) of the first non-finite entry (lane None for 1-D)."""
    bad = ~np.isfinite(arr)
    flat = int(np.argmax(bad))
    if arr.ndim == 1:
        return None, flat
    return flat // arr.shape[1], flat % arr.shape[1]


def _check_finite(arr, name: str) -> None:
    """Finiteness check; localizes the offending entry only on failure
    (the pass path is one reduction, no per-element work)."""
    if _is_torch_tensor(arr):
        import torch
        with span("repro.sync"):
            finite = bool(torch.isfinite(arr).all())
        if finite:
            return
    elif np.isfinite(np.asarray(arr)).all():
        return
    host = _host(arr)
    lane, index = _first_nonfinite(host)
    kind = "NaN" if np.isnan(host.reshape(-1)[
        (0 if lane is None else lane * host.shape[1]) + index]) else "Inf"
    where = (f"index {index}" if lane is None
             else f"lane {lane}, index {index}")
    raise InvalidInputError(
        f"{name} contains {kind} at {where}; poisoned problems are "
        f"rejected at the front door (fix the input or filter the lane)",
        field=name, lane=lane, index=index)


def _is_floating(arr) -> bool:
    if _is_torch_tensor(arr):
        return arr.dtype.is_floating_point
    return np.issubdtype(np.asarray(arr).dtype, np.floating)


def validate_problem(d, e, *, name: str = "problem",
                     check_finite: bool = True):
    """Validate a tridiagonal (d, e) pair: shapes, dtype, finiteness.

    Accepts 1-D ``(n,)/(n-1,)`` or stacked ``(B, n)/(B, n-1)`` numpy
    arrays or torch tensors.  Raises :class:`InvalidInputError` naming
    the offending field/lane/index.  Returns ``(d, e)`` as given.
    """
    d_shape = tuple(np.shape(d))
    e_shape = tuple(np.shape(e))
    if len(d_shape) not in (1, 2):
        raise InvalidInputError(
            f"{name}: d must be 1-D (n,) or stacked 2-D (B, n), got "
            f"shape {d_shape}", field="d")
    if d_shape[-1] == 0 or (len(d_shape) == 2 and d_shape[0] == 0):
        raise InvalidInputError(
            f"{name}: d must be non-empty, got shape {d_shape}", field="d")
    if len(e_shape) != len(d_shape):
        raise InvalidInputError(
            f"{name}: e must have d's rank; got d {d_shape} vs e "
            f"{e_shape}", field="e")
    n = d_shape[-1]
    if e_shape[-1] != max(n - 1, 0) or (len(d_shape) == 2
                                        and e_shape[0] != d_shape[0]):
        raise InvalidInputError(
            f"{name}: e must have shape {d_shape[:-1] + (max(n - 1, 0),)} "
            f"(n-1 off-diagonals per lane of d {d_shape}), got {e_shape}",
            field="e")
    for arr, field in ((d, "d"), (e, "e")):
        if not _is_floating(arr):
            raise InvalidInputError(
                f"{name}: {field} must be real floating point, got dtype "
                f"{arr.dtype}", field=field)
    if check_finite:
        _check_finite(d, "d")
        if n > 1:
            _check_finite(e, "e")
    return d, e


# Equilibration thresholds.  The recurrences square the off-diagonals,
# so the working range is the square root of the dtype's: any scale
# outside [2^-safe, 2^safe] is scaled by an exact power of two to ~1.
_SAFE_EXP = {"float64": 500, "float32": 60, "float16": 6}


def _dtype_name(arr) -> str:
    if _is_torch_tensor(arr):
        return str(arr.dtype).replace("torch.", "")
    return np.asarray(arr).dtype.name


def equilibrate(d, e):
    """Overflow/underflow-safe scaling of (d, e) -- LAPACK's orgnrm guard.

    Returns ``(d_scaled, e_scaled, scale)``; callers multiply output
    eigenvalues by ``1 / scale`` (exact: ``scale`` is a power of two).
    In-range problems come back untouched with ``scale == 1.0``.
    """
    if _is_torch_tensor(d):
        with span("repro.sync"):
            dmax = float(d.abs().max())
        emax = 0.0
        if e.shape[-1]:
            with span("repro.sync"):
                emax = float(e.abs().max())
    else:
        dmax = float(np.max(np.abs(d)))
        emax = float(np.max(np.abs(e))) if np.shape(e)[-1] else 0.0
    orgnrm = max(dmax, emax)
    safe = _SAFE_EXP.get(_dtype_name(d), 500)
    if orgnrm == 0.0 or 2.0 ** -safe <= orgnrm <= 2.0 ** safe:
        return d, e, 1.0
    # Exact power-of-two factor bringing orgnrm into [0.5, 1).
    scale = 2.0 ** -(math.frexp(orgnrm)[1])
    return d * scale, e * scale, float(scale)


def robustness_counters() -> dict:
    """Process-wide robustness counter snapshot."""
    return {"degradations": DEGRADATIONS.count,
            "deadline_expired": DEADLINES.count}


def reset_robustness_counters() -> None:
    DEGRADATIONS.reset()
    DEADLINES.reset()
