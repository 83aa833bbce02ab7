"""Public eigensolver API of the port.

    from repro_torch.core import eigvalsh_tridiagonal
    lam = eigvalsh_tridiagonal(d, e)                 # on the CUDA card
    lam = eigvalsh_tridiagonal(d, e, device="cpu")   # plain torch path
    lam = eigvalsh_tridiagonal(D, E)                 # stacked (B, n) batch
    lam = eigvalsh_tridiagonal(d, e, method="bisect")      # Sturm bisection
    lam = eigvalsh_tridiagonal(d, e, method="sterf")       # QL baseline
    lam = eigvalsh_tridiagonal(d, e, method="lazy")        # lazy-replay D&C
    lam = eigvalsh_tridiagonal(d, e, method="full")        # full-vector D&C
    lam = eigvalsh_tridiagonal(d, e, fused=False)          # two-pass conquer
    lam = eigvalsh_tridiagonal(d, e, precision="mixed")    # f32 tree + f64
    lam = eigvalsh_tridiagonal(d, e, certify=True)         # Sturm-certified
    top = eigvalsh_tridiagonal_range(d, e, il=n - 8, iu=n - 1)

A thin wrapper over the request core (``repro_torch.core.request``):
the arguments become a :class:`SolveRequest`, which is routed to its
bucketed plan and executed.  Inputs are numpy arrays or torch tensors;
results are torch tensors on the solve's device.
"""

from __future__ import annotations

from repro_torch.core.bisect import eigvalsh_tridiagonal_range  # noqa: F401
from repro_torch.core.br_dc import (eigvalsh_tridiagonal_batch,  # noqa: F401
                                    eigvalsh_tridiagonal_br)     # noqa: F401
from repro_torch.core.request import (METHODS, SolveRequest, SolveResult,
                                      execute_request, route_request)

__all__ = ["METHODS", "SolveRequest", "SolveResult", "eigvalsh_tridiagonal",
           "eigvalsh_tridiagonal_batch", "eigvalsh_tridiagonal_br",
           "eigvalsh_tridiagonal_range", "execute_request", "route_request"]


def eigvalsh_tridiagonal(d, e, method: str = "br", device=None, **knobs):
    """All eigenvalues (ascending) of the symmetric tridiagonal (d, e).

    1-D inputs solve one problem and return (n,); stacked (B, n) /
    (B, n-1) inputs return (B, n), solved natively batched for "br" and
    "bisect" and one problem at a time for the baselines ("sterf",
    "lazy", "full", "eigh"), which exist to model per-problem state.
    Runs on the CUDA card unless ``device="cpu"``; with no card and no
    ``device="cpu"`` it raises.

    ``method="br"`` (boundary-row D&C) takes the knobs of
    :func:`repro_torch.core.br_dc.eigvalsh_tridiagonal_br` (plus
    ``dtype``), ``precision="mixed"`` among them; ``method="bisect"``
    (Sturm bisection of every index) takes ``maxiter`` and ``polish``.
    Every method accepts ``certify=True``: one extra batched Sturm-count
    sweep verifies each eigenvalue against (d, e) and escalates misses or
    non-finite outputs down the degradation ladder (mixed -> native D&C
    -> per-lane bisection).  The baselines take the knobs of their
    functions: ``leaf``, ``chunk``, ``niter``, ``use_zhat`` and ``dtype``
    for "lazy" and "full" (:mod:`repro_torch.core.baselines`), ``dtype``
    for "sterf"; "eigh" is ``torch.linalg.eigvalsh`` of the dense matrix.
    """
    kind = "batch" if len(getattr(d, "shape", ())) == 2 else "full"
    req = SolveRequest(d=d, e=e, kind=kind, method=method,
                       return_boundary=bool(knobs.pop("return_boundary",
                                                      False)),
                       certify=bool(knobs.pop("certify", False)),
                       deadline_ms=knobs.pop("deadline_ms", None),
                       knobs=knobs, device=device)
    return execute_request(req).eigenvalues
