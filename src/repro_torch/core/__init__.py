"""PyTorch port of ``repro.core``: the boundary-row D&C eigensolver's main
path (``eigvalsh_tridiagonal(d, e)``, method "br", full and batched).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the merge levels' secular solve, post-pass and resident
merge are the hand-written kernels of ``repro_torch.kernels`` there.
"""

from repro_torch.core.api import eigvalsh_tridiagonal, METHODS
from repro_torch.core.br_dc import (
    BRBatchResult,
    BRResult,
    SOLVE_COUNTER,
    eigvalsh_tridiagonal_batch,
    eigvalsh_tridiagonal_br,
    workspace_model,
)
from repro_torch.core.guard import (CertificationError, DeadlineExceeded,
                                    InvalidInputError, equilibrate,
                                    validate_problem)
from repro_torch.core.plan import (
    EXECUTOR_TRACES,
    PlanKey,
    SolvePlan,
    clear_plan_cache,
    make_plan,
    plan_cache_stats,
    plan_for_route,
    resolve_solve_route,
    route_key_tuple,
)
from repro_torch.core.request import (
    KINDS,
    RoutedRequest,
    SolveRequest,
    SolveResult,
    execute_request,
    route_request,
)
from repro_torch.core.secular import secular_eigenvalues, secular_solve
from repro_torch.core.tridiag import (
    FAMILIES,
    dense_from_tridiag,
    gershgorin_bounds,
    make_family,
    make_family_batch,
)

__all__ = [
    "BRBatchResult", "BRResult", "CertificationError", "DeadlineExceeded",
    "EXECUTOR_TRACES", "FAMILIES", "InvalidInputError", "KINDS", "METHODS",
    "PlanKey", "RoutedRequest", "SOLVE_COUNTER", "SolvePlan", "SolveRequest",
    "SolveResult", "clear_plan_cache", "dense_from_tridiag", "equilibrate",
    "eigvalsh_tridiagonal", "eigvalsh_tridiagonal_batch",
    "eigvalsh_tridiagonal_br", "execute_request", "gershgorin_bounds",
    "make_family", "make_family_batch", "make_plan", "plan_cache_stats",
    "plan_for_route", "resolve_solve_route", "route_key_tuple",
    "route_request", "secular_eigenvalues", "secular_solve",
    "validate_problem", "workspace_model",
]
