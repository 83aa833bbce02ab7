"""Request/response core: every eigensolve is a routable SolveRequest
(port of ``repro.core.request``).

    SolveRequest -> route_request -> RoutedRequest -> execute_request

Routing validates and normalizes the input once (the guarded front door:
shapes, dtype, NaN/Inf, equilibration by an exact power of two) and
resolves the bucketed key the launch will use: a
:class:`~repro_torch.core.plan.PlanKey` for the boundary-row tree
(``method="br"``) or a :class:`~repro_torch.core.plan.RangePlanKey` for
the Sturm-count path (``kind="range"``, ``kind="edges"``,
``method="bisect"``).  The baseline methods ("sterf", "lazy", "full",
"eigh") and the n == 1 short circuits route to None and run directly, one
problem at a time.

Request kinds:

    full   -- one problem, all eigenvalues            -> (n,)
    batch  -- B stacked problems, all eigenvalues     -> (B, n)
    range  -- selected eigenvalues by index or value  -> (k,) / (B, k)
    slq    -- batch + boundary rows (the SLQ quadrature rule: nodes are
              the eigenvalues, weights are blo(Q)^2)  -> (B, n) + rows
    edges  -- k smallest + k largest of each problem  -> (2B, k)
              (rows [0, B) the ascending bottom-k, rows [B, 2B) the
              ascending top-k -- the spectral monitor's probe), routed
              onto the same RangePlanKey as plain range traffic of equal
              (n, k, dtype): the rows are duplicated and each copy slices
              its own window in one launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import guard as _guard
from repro_torch.runtime import faults as _faults

KINDS = ("full", "batch", "range", "slq", "edges")

METHODS = ("br", "sterf", "lazy", "full", "eigh", "bisect")


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One eigensolve, as data.  ``knobs`` holds the solver keywords of
    the matching sync entry point (leaf, chunk, niter, precision,
    refine_tol, ... for "br"; maxiter, polish for "bisect"/range; k for
    edges; dtype for any); ``device`` is where it runs (None: the CUDA
    card).

    Distributed conquer rides the same knobs: "br" requests accept
    ``mesh`` (default "auto", see ``br_dc.eigvalsh_tridiagonal_br``) and
    ``compress_halo``.  The shard count and the mesh's devices land in the
    route key, so the serving scheduler coalesces same-mesh traffic and
    never mixes mesh shapes in a flush.

    ``certify=True`` asks for a Sturm-certified result: one extra batched
    count sweep (``bisect.certify_spectrum``) verifies every returned
    eigenvalue against the original (d, e), and any miss -- or non-finite
    output -- escalates down the degradation ladder (mixed -> native
    D&C -> per-lane Sturm bisection); ``SolveResult.diagnostics`` records
    what happened.  Range and bisect solves are count-verified by
    construction and certify for free.  ``deadline_ms`` is validated here
    and enforced by the serving engine (``repro_torch.serve``).
    """
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
    device), plus boundary rows when asked for.  ``diagnostics`` is None
    on the steady-state path, else a dict: ``certified`` / ``lanes`` (the
    certificate tally of ``certify=True``), ``escalations`` (tuple of
    ``{"from", "to", "lanes"}`` ladder records) and
    ``equilibration_scale``."""
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
    batch-unresolved PlanKey or RangePlanKey (None: direct, n == 1 of a
    tree solve).  Range routes carry the resolved index window (``il`` an
    int, or a (batch,) array for ``kind="edges"``; width ``k``);
    ``empty`` marks a value window with no eigenvalues."""
    request: SolveRequest
    d: Any
    e: Any
    batch: int
    n: int
    route: Any
    il: Any = 0
    k: int = 0
    empty: bool = False
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
    if req.deadline_ms is not None:
        deadline = float(req.deadline_ms)
        if not (deadline > 0.0) or not np.isfinite(deadline):
            raise _guard.InvalidInputError(
                f"deadline_ms must be a positive finite budget, got "
                f"{req.deadline_ms!r}", field="deadline_ms")
    d = _as_host(req.d)
    e = _as_host(req.e)
    dtype = req.knobs.get("dtype")
    if dtype is None and req.knobs.get("precision") == "mixed":
        dtype = np.float64   # mixed certifies / returns in f64
    if dtype is not None:
        d = _astype(d, dtype)
        e = _astype(e, dtype)
    if e.dtype != d.dtype:
        e = _astype(e, d.dtype)
    single = d.ndim == 1
    if req.kind == "full" and not single:
        raise ValueError(
            f"kind='full' expects 1-D d, got shape {tuple(d.shape)}")
    if req.kind in ("batch", "slq", "edges") and single:
        raise ValueError(
            f"kind={req.kind!r} expects stacked (B, n) d, got 1-D")
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


def _range_knobs(kw: dict, what: str, extra=()) -> dict:
    unknown = set(kw) - {"maxiter", "polish", "dtype", *extra}
    if unknown:
        raise TypeError(
            f"{what} requests accept knobs "
            f"({', '.join((*extra, 'maxiter', 'polish', 'dtype'))}); "
            f"got unexpected {sorted(unknown)}")
    return {k: v for k, v in kw.items() if k in ("maxiter", "polish")}


def _cat_rows(a):
    return torch.cat([a, a]) if isinstance(a, torch.Tensor) \
        else np.concatenate([a, a])


def route_request(req: SolveRequest) -> RoutedRequest:
    """Resolve a request to its (batch-unresolved) plan key; raises on
    malformed requests.
    Touches no plan cache; the only device work is the two Sturm counts
    a ``select="v"`` window needs."""
    from repro_torch.core import plan as _plan
    d, e, single, scale = _normalize(req)
    B, n = d.shape
    kw = {k: v for k, v in req.knobs.items() if k != "return_boundary"}

    if req.method != "br" and (req.return_boundary or req.kind == "slq"):
        # Boundary rows are BR selected-row state: a result without them
        # would let a caller believe the flag took effect.
        raise TypeError(
            "return_boundary (and kind='slq') require method='br'; got "
            f"method={req.method!r}")

    if req.kind == "edges":
        # k smallest + k largest of each problem as ONE sliced launch:
        # rows [0, B) carry the bottom-k window il=0, rows [B, 2B) the
        # top-k window il=n-k, so the key is the plain range key of (n, k).
        if req.return_boundary:
            raise TypeError(
                "kind='edges' returns extremal eigenvalues only; boundary "
                "rows are full-conquer state (use kind='slq')")
        if (req.il, req.iu, req.vl, req.vu) != (None, None, None, None):
            raise ValueError(
                "kind='edges' selects its own index windows (bottom-k and "
                "top-k); pass k via knobs, not il/iu/vl/vu")
        k = kw.pop("k", 1)
        if not (isinstance(k, (int, np.integer)) and 1 <= int(k) <= n):
            raise ValueError(
                f"edges knob k must be an int in [1, n={n}]; got {k!r}")
        k = int(k)
        range_kw = _range_knobs(kw, "edges", extra=("k",))
        # (d, e) are already equilibrated: both copies share the exact
        # power-of-two scale, so the inverse scaling stays exact.
        il = np.concatenate([np.zeros(B, np.int64),
                             np.full(B, n - k, np.int64)])
        route = _plan.resolve_range_route(n, k, dtype=d.dtype,
                                          device=req.device, **range_kw)
        return RoutedRequest(request=req, d=_cat_rows(d), e=_cat_rows(e),
                             batch=2 * B, n=n, route=route, il=il, k=k,
                             single=False, scale=scale)

    if req.kind == "range" or req.method == "bisect":
        range_kw = _range_knobs(
            kw, "range" if req.kind == "range" else "bisect")
        if req.kind == "range":
            il, k, empty = _resolve_window(req, d, e, single, scale)
        else:
            il, k, empty = 0, n, False   # full-spectrum bisection
        route = None
        if not empty:
            route = _plan.resolve_range_route(n, k, dtype=d.dtype,
                                              device=req.device, **range_kw)
        else:
            _plan.resolve_device(req.device)
        return RoutedRequest(request=req, d=d, e=e, batch=B, n=n,
                             route=route, il=il, k=k, empty=empty,
                             single=single, scale=scale)

    if req.method == "br" and n > 1:
        return_boundary = req.return_boundary or req.kind == "slq"
        if req.kind == "full":
            # Single (possibly padded) leaf trees return their boundary
            # rows for free (eigvalsh_tridiagonal_br's L == 0 contract).
            from repro_torch.core.br_dc import _tree_shape
            leaf = _plan.resolve_leaf(kw.get("leaf"), n, d.dtype,
                                      kw.get("precision", "native"),
                                      req.device)
            return_boundary = return_boundary or _tree_shape(n, leaf)[1] == 0
        route = _plan.resolve_solve_route(
            n, return_boundary=return_boundary, dtype=d.dtype,
            device=req.device, certify=req.certify,
            **{k: v for k, v in kw.items() if k != "dtype"})
        return RoutedRequest(request=req, d=d, e=e, batch=B, n=n,
                             route=route, single=single, scale=scale)
    # Baselines (and the n == 1 short circuits): direct, uncoalescable.
    _plan.resolve_device(req.device)
    return RoutedRequest(request=req, d=d, e=e, batch=B, n=n, route=None,
                         single=single, scale=scale)


def _resolve_window(req: SolveRequest, d, e, single: bool,
                    scale: float = 1.0):
    """Turn a range request's selection into an index window
    (il, k, empty)."""
    from repro_torch.core.bisect import _validate_index_range, sturm_count
    n = d.shape[1]
    if req.select == "i":
        if req.il is None or req.iu is None:
            raise ValueError("select='i' requires il and iu")
        il, iu = _validate_index_range(n, req.il, req.iu)
        return il, iu - il + 1, False
    if req.select == "v":
        if req.vl is None or req.vu is None:
            raise ValueError("select='v' requires vl and vu")
        if not (float(req.vl) < float(req.vu)):
            raise ValueError(
                f"select='v' requires vl < vu; got ({req.vl}, {req.vu})")
        if not single:
            raise ValueError(
                "select='v' supports single problems only (the number of "
                "eigenvalues in (vl, vu] differs per problem); loop or "
                "use select='i'")
        # Two Sturm counts turn the value window into an index window.
        # (d, e) are already equilibrated, so the endpoints scale by the
        # same exact power of two: count(scale*v; scaled T) == count(v; T).
        shifts = np.asarray([req.vl, req.vu], np.float64) * scale
        bounds = sturm_count(d[0], e[0], shifts.astype(str(d.dtype).replace(
            "torch.", "")), device=req.device)
        c_lo, c_hi = int(bounds[0]), int(bounds[1])
        if c_hi <= c_lo:
            return 0, 0, True
        return c_lo, c_hi - c_lo, False
    raise ValueError(f"select must be 'i' or 'v', got {req.select!r}")


def _native_knobs(req: SolveRequest) -> dict:
    """Solver knobs for a ladder's native re-solve: drop the knobs that
    name the stage being escalated away from (precision, refine_tol) and
    the topology knobs a single-problem recovery solve must not inherit
    (mesh, compress_halo)."""
    drop = ("precision", "refine_tol", "mesh", "compress_halo",
            "return_boundary")
    kw = {k: v for k, v in req.knobs.items() if k not in drop}
    kw["mesh"] = None   # the classic single-device path, whatever "auto" says
    return kw


def _bisect_lanes(routed: RoutedRequest, lam, mask) -> None:
    """Final ladder rung: re-solve the masked eigenvalue lanes by Sturm
    bisection against the (scaled) inputs, in place in ``lam``.

    Bisection brackets every target with exact integer counts, so its
    results are certified by construction -- and it runs through
    ``bisect._slice_targets`` directly, never through the
    fault-instrumented plan path, so the ladder ends even under a
    persistent launch fault.
    """
    from repro_torch.core import bisect as _bis
    dev = lam.device
    for b in torch.nonzero(mask.any(dim=1)).flatten().tolist():
        idx = torch.nonzero(mask[b]).flatten()
        d_b = torch.as_tensor(routed.d[b], device=dev)[None, :]
        e_b = torch.as_tensor(routed.e[b], device=dev)[None, :]
        vals = _bis._slice_targets(d_b, e_b,
                                   idx.to(torch.int32)[None, :])
        lam[b, idx] = vals[0].to(lam.dtype)


def _resolve_native_rows(routed: RoutedRequest, prob, lam, blo,
                         bhi):
    """Ladder rung: full native re-solve of the masked problems (the only
    rung that can regenerate boundary rows), in place.  Returns the (B,)
    mask of problems re-solved; failures (e.g. a persistent injected
    launch fault) are left for the next rung."""
    kw = _native_knobs(routed.request)
    if blo is not None:
        kw["return_boundary"] = True
    done = torch.zeros_like(prob)
    for b in torch.nonzero(prob).flatten().tolist():
        try:
            lamb, lob, hib = _solve_direct_single(
                routed.d[b], routed.e[b], "br", kw, lam.device)
        except Exception:
            continue
        lam[b] = lamb.to(lam.dtype)
        if blo is not None and lob is not None:
            blo[b] = lob.to(blo.dtype)
            bhi[b] = hib.to(bhi.dtype)
        done[b] = True
    return done


def _finalize_lanes(routed: RoutedRequest, lam, blo=None, bhi=None, *,
                    cert=None, check_finite: bool = True):
    """The graceful-degradation ladder + inverse equilibration.

    lam/blo/bhi are the solve's stacked (B, n) outputs in SCALED space;
    ``cert`` an optional (B, n) certificate mask.  Ladder, per lane where
    possible:

      1. non-finite outputs: full native re-solve of the affected
         problems when the stage was mixed (escalate precision) or when
         boundary rows are owed (bisection cannot produce rows);
      2. lanes still bad, and any certificate misses: per-lane Sturm
         bisection, certified by construction;
      3. still bad (rows owed but unrecoverable): CertificationError.

    Every escalation is recorded in the SOLVE_COUNTER degradation gauge,
    the ``guard.DEGRADATIONS`` counter and the returned diagnostics.
    Returns (lam, blo, bhi, diagnostics).
    """
    from repro_torch.core import br_dc as _br
    req = routed.request
    mixed = getattr(routed.route, "precision", "native") == "mixed"
    stage = ("mixed" if mixed
             else "native" if routed.route is not None else req.method)
    rows = blo is not None
    escalations: list = []
    cert_h = None if cert is None else cert.clone()
    first_sweep_certified = None if cert_h is None else int(cert_h.sum())

    def record(frm: str, to: str, lanes: int) -> None:
        _br.SOLVE_COUNTER.record_degradation(frm, to, lanes)
        _guard.DEGRADATIONS.increment()
        escalations.append({"from": frm, "to": to, "lanes": int(lanes)})

    def non_finite():
        bad = ~torch.isfinite(lam)
        if rows:
            bad |= ~torch.isfinite(blo).all(dim=1, keepdim=True)
            bad |= ~torch.isfinite(bhi).all(dim=1, keepdim=True)
        return bad

    if check_finite:
        bad = non_finite()
        if bool(bad.any()):
            lam = lam.clone()
            blo = blo.clone() if rows else None
            bhi = bhi.clone() if rows else None
            at = stage
            if mixed or rows:
                done = _resolve_native_rows(routed, bad.any(dim=1), lam,
                                            blo, bhi)
                if bool(done.any()):
                    record(stage, "native", int(bad[done].sum()))
                    at = "native"
                bad = non_finite()
            if bool(bad.any()):
                if rows:
                    raise _guard.CertificationError(
                        f"degradation ladder exhausted: {int(bad.sum())} "
                        f"non-finite output lanes remain and the request "
                        f"owes boundary rows, which bisection cannot "
                        f"produce")
                record(at, "bisect", int(bad.sum()))
                _bisect_lanes(routed, lam, bad)
                if cert_h is not None:
                    cert_h[bad] = True   # count-verified by construction
                still = ~torch.isfinite(lam)
                if bool(still.any()):
                    raise _guard.CertificationError(
                        f"degradation ladder exhausted: {int(still.sum())} "
                        f"lanes non-finite even after Sturm bisection")
            # Re-certify lanes repaired by a native re-solve (bisected
            # lanes are already accounted above).
            if cert_h is not None and not bool(cert_h.all()):
                from repro_torch.core import bisect as _bis
                tol = (getattr(routed.route, "refine_tol", 0.0)
                       or _bis.DEFAULT_REFINE_TOL)
                for b in torch.nonzero((~cert_h).any(dim=1)
                                       ).flatten().tolist():
                    cert_h[b] = _bis.certify_spectrum(
                        routed.d[b], routed.e[b], lam[b], tol=tol,
                        device=lam.device).certified

    if cert_h is not None and not bool(cert_h.all()):
        miss = ~cert_h
        lam = lam.clone()
        record(stage, "bisect", int(miss.sum()))
        _bisect_lanes(routed, lam, miss)

    if routed.scale != 1.0:
        # Exact inverse of the power-of-two equilibration factor.
        lam = lam * (1.0 / routed.scale)

    diag = None
    if escalations or cert_h is not None or routed.scale != 1.0:
        diag = {}
        if cert_h is not None:
            diag["certified"] = first_sweep_certified
            diag["lanes"] = int(cert_h.numel())
        if escalations:
            diag["escalations"] = tuple(escalations)
        if routed.scale != 1.0:
            diag["equilibration_scale"] = routed.scale
    return lam, blo, bhi, diag


def _solve_direct_single(d, e, method: str, kw: dict, device):
    """One problem through the non-plan paths: the baselines, and "br"
    for the ladder's native re-solve.  Returns (eigenvalues, blo, bhi)."""
    from repro_torch.core import baselines as _bl
    from repro_torch.core.br_dc import eigvalsh_tridiagonal_br
    from repro_torch.core.sterf import eigvalsh_tridiagonal_sterf
    if method == "br":
        res = eigvalsh_tridiagonal_br(d, e, device=device, **kw)
        return res.eigenvalues, res.blo, res.bhi
    if method == "sterf":
        return eigvalsh_tridiagonal_sterf(d, e, device=device, **kw), None, None
    if method == "lazy":
        return (_bl.eigvalsh_tridiagonal_lazy(d, e, device=device, **kw),
                None, None)
    if method == "full":
        return (_bl.eigvalsh_tridiagonal_full_discard(d, e, device=device,
                                                      **kw), None, None)
    if method == "eigh":
        # The dense symmetric matrix and one library eigensolve, as the
        # JAX package does it.
        from repro_torch.core.tridiag import dense_from_tridiag
        A = dense_from_tridiag(*(x.cpu().numpy() if isinstance(
            x, torch.Tensor) else np.asarray(x) for x in (d, e)))
        return (torch.linalg.eigvalsh(torch.as_tensor(A, device=device)),
                None, None)
    raise ValueError(f"unknown method {method!r}; choose from {METHODS}")


def _unwrap(single: bool, *arrays):
    return tuple(None if a is None else a[0] for a in arrays) if single \
        else arrays


def execute_request(req: SolveRequest | RoutedRequest) -> SolveResult:
    """Execute a (routed) request synchronously: the single launch path
    the sync API wraps."""
    from repro_torch.core import br_dc as _br
    from repro_torch.core import plan as _plan
    routed = route_request(req) if isinstance(req, SolveRequest) else req
    req = routed.request

    if routed.empty:
        dev = _plan.resolve_device(req.device)
        lam = torch.zeros((routed.batch, 0), dtype=_plan._torch_dtype(
            _plan._dtype_name(routed.d.dtype)), device=dev)
        return SolveResult(eigenvalues=_unwrap(routed.single, lam)[0],
                           kind=req.kind, method=req.method)

    if isinstance(routed.route, _plan.RangePlanKey):
        plan = _plan.range_plan_for_route(routed.route, routed.batch)
        lam = plan.execute(routed.d, routed.e, routed.il, routed.k)
        diag = None
        if routed.scale != 1.0:
            lam = lam * (1.0 / routed.scale)
            diag = {"equilibration_scale": routed.scale}
        if req.certify:
            # Sturm bisection IS a certificate: every returned value is
            # enclosed by exact integer counts, so the tally needs no
            # extra sweep.
            diag = dict(diag or ())
            diag.update(certified=int(routed.batch * routed.k),
                        lanes=int(routed.batch * routed.k))
        return SolveResult(eigenvalues=_unwrap(routed.single, lam)[0],
                           kind=req.kind, method=req.method,
                           diagnostics=diag)

    if routed.route is not None:
        route = routed.route
        res = _plan.plan_for_route(route, routed.batch).execute(
            routed.d, routed.e)
        lam, blo, bhi = res.eigenvalues, res.blo, res.bhi
        cert = None
        if route.certify:
            from repro_torch.core import bisect as _bis
            cert = _bis.certify_spectrum(
                routed.d, routed.e, lam, tol=route.refine_tol,
                device=lam.device).certified
        # Output finiteness is checked when something already forces a
        # host round trip (certification, the mixed refinement) or when
        # the chaos harness is live: the front door rejected input
        # poison, so a non-finite native output means a device fault.
        check = (route.certify or _faults.faults_enabled()
                 or route.precision == "mixed")
        lam, blo, bhi, diag = _finalize_lanes(routed, lam, blo, bhi,
                                              cert=cert,
                                              check_finite=check)
    elif req.method != "br":
        # Direct path: the baselines, one problem at a time (these methods
        # exist to model per-problem quadratic state).
        dev = _plan.resolve_device(req.device)
        kw = {k: v for k, v in req.knobs.items() if k != "return_boundary"}
        lam = torch.stack([
            _solve_direct_single(routed.d[b], routed.e[b], req.method, kw,
                                 dev)[0] for b in range(routed.batch)])
        blo = bhi = diag = None
        if req.certify or routed.scale != 1.0 or _faults.faults_enabled():
            cert = None
            if req.certify:
                from repro_torch.core import bisect as _bis
                cert = _bis.certify_spectrum(routed.d, routed.e, lam,
                                             device=dev).certified
            lam, blo, bhi, diag = _finalize_lanes(routed, lam, cert=cert)
    else:
        # n == 1 of a tree solve: the eigenvalue is d itself.
        dev = _plan.resolve_device(req.device)
        lam, _ = _br._as_batch(routed.d, routed.e, None, dev)
        _br.SOLVE_COUNTER.increment()
        ones = torch.ones_like(lam)
        rows = req.return_boundary or req.kind == "slq"
        blo = bhi = ones if rows else None
        cert = None
        if req.certify:
            from repro_torch.core import bisect as _bis
            cert = _bis.certify_spectrum(routed.d, routed.e, lam,
                                         device=dev).certified
        lam, blo, bhi, diag = _finalize_lanes(routed, lam, blo, bhi,
                                              cert=cert,
                                              check_finite=req.certify)
    lam, blo, bhi = _unwrap(routed.single, lam, blo, bhi)
    return SolveResult(eigenvalues=lam, blo=blo, bhi=bhi, kind=req.kind,
                       method=req.method, diagnostics=diag)
