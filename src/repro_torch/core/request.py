"""Request/response core: every eigensolve is a routable SolveRequest
(port of ``repro.core.request`` for ``kind`` in ("full", "batch") with
``method="br"``).

    SolveRequest -> route_request -> RoutedRequest -> execute_request

Routing validates and normalizes the input once (the guarded front door:
shapes, dtype, NaN/Inf, equilibration by an exact power of two) and
resolves the bucketed :class:`~repro_torch.core.plan.PlanKey` the launch
will use.  Kinds and methods of later slices raise NotImplementedError
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import guard as _guard

KINDS = ("full", "batch", "range", "slq", "edges")

METHODS = ("br", "sterf", "lazy", "full", "eigh", "bisect")

# What brings the kinds and methods this slice does not run yet.
_BISECT = "Queue 1 item 7 (bisect.py + the Sturm-count kernel)"
_BASELINES = "Queue 1 item 8 (sterf.py + baselines.py)"
_LATER_KINDS = {"range": _BISECT, "edges": _BISECT,
                "slq": "Queue 1 item 11 (spectral/)"}
_LATER_METHODS = {"bisect": _BISECT, "sterf": _BASELINES,
                  "lazy": _BASELINES, "full": _BASELINES, "eigh": _BASELINES}


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One eigensolve, as data.  ``knobs`` holds the solver keywords of
    the matching sync entry point (leaf, chunk, niter, ... and dtype);
    ``device`` is where it runs (None: the CUDA card)."""
    d: Any
    e: Any
    kind: str = "full"
    method: str = "br"
    return_boundary: bool = False
    select: str = "i"
    il: int | None = None
    iu: int | None = None
    vl: float | None = None
    vu: float | None = None
    certify: bool = False
    deadline_ms: float | None = None
    knobs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    device: Any = None


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Eigenvalues in the kind's natural shape (tensors on the solve's
    device), plus boundary rows when asked for; ``diagnostics`` carries
    ``equilibration_scale`` when the input was rescaled."""
    eigenvalues: Any
    blo: Any = None
    bhi: Any = None
    kind: str = "full"
    method: str = "br"
    diagnostics: Any = None


@dataclasses.dataclass(frozen=True)
class RoutedRequest:
    """A validated request bound to its route: ``d``/``e`` are stacked
    (B, n)/(B, n-1) arrays of the solve dtype; ``route`` is the
    batch-unresolved PlanKey (None: direct, n == 1)."""
    request: SolveRequest
    d: Any
    e: Any
    batch: int
    n: int
    route: Any
    single: bool = False   # caller passed 1-D arrays: unwrap on the way out
    scale: float = 1.0     # exact power-of-two equilibration factor

    @property
    def return_boundary(self) -> bool:
        return bool(getattr(self.route, "return_boundary", False))


def _as_host(x):
    """Tensors stay where they are; everything else becomes numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _astype(x, dtype):
    if isinstance(x, torch.Tensor):
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        return x.to(dtype)
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    return x.astype(dtype)


def _normalize(req: SolveRequest):
    """Validate kind/method/input and normalize d, e to stacked (B, n)
    arrays; returns (d, e, single, scale)."""
    if req.kind not in KINDS:
        raise ValueError(f"unknown kind {req.kind!r}; choose from {KINDS}")
    if req.method not in METHODS:
        raise ValueError(
            f"unknown method {req.method!r}; choose from {METHODS}")
    later = (_LATER_KINDS.get(req.kind) and f"kind={req.kind!r}",
             _LATER_METHODS.get(req.method) and f"method={req.method!r}",
             req.certify and "certify=True")
    for what, item in zip(later, (_LATER_KINDS.get(req.kind),
                                  _LATER_METHODS.get(req.method), _BISECT)):
        if what:
            raise NotImplementedError(
                f"{what} is not ported to repro_torch yet (ROADMAP {item})")
    if req.deadline_ms is not None:
        deadline = float(req.deadline_ms)
        if not (deadline > 0.0) or not np.isfinite(deadline):
            raise _guard.InvalidInputError(
                f"deadline_ms must be a positive finite budget, got "
                f"{req.deadline_ms!r}", field="deadline_ms")
    d = _as_host(req.d)
    e = _as_host(req.e)
    dtype = req.knobs.get("dtype")
    if dtype is not None:
        d = _astype(d, dtype)
        e = _astype(e, dtype)
    if e.dtype != d.dtype:
        e = _astype(e, d.dtype)
    single = d.ndim == 1
    if req.kind == "full" and not single:
        raise ValueError(
            f"kind='full' expects 1-D d, got shape {tuple(d.shape)}")
    if req.kind == "batch" and single:
        raise ValueError("kind='batch' expects stacked (B, n) d, got 1-D")
    if single:
        d = d[None, :]
        e = e[None, :] if e.ndim == 1 else e
    if (d.ndim != 2 or e.ndim != 2 or e.shape[0] != d.shape[0]
            or e.shape[1] != max(d.shape[1] - 1, 0)):
        raise ValueError(
            f"batched solve expects d (B, n) and e (B, n-1); "
            f"got {tuple(d.shape)} / {tuple(e.shape)}")
    _guard.validate_problem(d, e, name="request")
    d, e, scale = _guard.equilibrate(d, e)
    return d, e, single, scale


def route_request(req: SolveRequest) -> RoutedRequest:
    """Resolve a request to its (batch-unresolved) plan key; raises on
    malformed requests and on kinds, methods and knobs of later slices."""
    from repro_torch.core import plan as _plan
    d, e, single, scale = _normalize(req)
    B, n = d.shape
    kw = {k: v for k, v in req.knobs.items()
          if k not in ("return_boundary", "dtype")}
    if n > 1:
        return_boundary = req.return_boundary
        if req.kind == "full":
            # Single (possibly padded) leaf trees return their boundary
            # rows for free (eigvalsh_tridiagonal_br's L == 0 contract).
            from repro_torch.core.br_dc import _tree_shape
            leaf = _plan.resolve_leaf(kw.get("leaf"), n, d.dtype,
                                      kw.get("precision", "native"))
            return_boundary = return_boundary or _tree_shape(n, leaf)[1] == 0
        route = _plan.resolve_solve_route(
            n, return_boundary=return_boundary, dtype=d.dtype,
            device=req.device, **kw)
        return RoutedRequest(request=req, d=d, e=e, batch=B, n=n,
                             route=route, single=single, scale=scale)
    # n == 1 short circuit: direct, no plan.
    _plan.resolve_device(req.device)
    return RoutedRequest(request=req, d=d, e=e, batch=B, n=n, route=None,
                         single=single, scale=scale)


def _finalize_lanes(routed: RoutedRequest, lam):
    """Undo equilibration: multiply by the exact inverse power of two.
    (The JAX package's degradation ladder around it comes with certify,
    ROADMAP Queue 1 item 7.)  Returns (lam, diagnostics)."""
    if routed.scale == 1.0:
        return lam, None
    return (lam * (1.0 / routed.scale),
            {"equilibration_scale": routed.scale})


def execute_request(req: SolveRequest | RoutedRequest) -> SolveResult:
    """Execute a (routed) request synchronously: the single launch path
    the sync API wraps."""
    from repro_torch.core import br_dc as _br
    from repro_torch.core import plan as _plan
    routed = route_request(req) if isinstance(req, SolveRequest) else req
    req = routed.request
    if routed.route is not None:
        res = _plan.plan_for_route(routed.route, routed.batch).execute(
            routed.d, routed.e)
        lam, blo, bhi = res.eigenvalues, res.blo, res.bhi
    else:
        dev = _plan.resolve_device(req.device)
        lam, _ = _br._as_batch(routed.d, routed.e, None, dev)
        _br.SOLVE_COUNTER.increment()
        ones = torch.ones_like(lam)
        blo = bhi = ones if req.return_boundary else None
    lam, diag = _finalize_lanes(routed, lam)
    if routed.single:
        lam = lam[0]
        blo = None if blo is None else blo[0]
        bhi = None if bhi is None else bhi[0]
    return SolveResult(eigenvalues=lam, blo=blo, bhi=bhi, kind=req.kind,
                       method=req.method, diagnostics=diag)
