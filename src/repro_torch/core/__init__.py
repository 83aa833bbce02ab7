"""PyTorch port of ``repro.core``: the boundary-row D&C eigensolver
(``eigvalsh_tridiagonal(d, e)``, method "br", full and batched, native or
``precision="mixed"``, optionally ``certify=True``) and the Sturm-count
path (``eigvalsh_tridiagonal_range``, ``kind="edges"``,
``method="bisect"``, ``certify_spectrum``), and the paper's comparison
points: the QL baseline (``method="sterf"``), the lazy-replay and
full-vector D&C baselines (``method="lazy"``, ``"full"``), the dense
library solve (``"eigh"``) and the two-pass conquer (``fused=False``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the merge levels' secular solve, post-pass, resident
merge and two-pass weights and row update, the Sturm counts and the QL
iteration are the hand-written kernels of ``repro_torch.kernels`` there.
"""

from repro_torch.core.api import eigvalsh_tridiagonal, METHODS
from repro_torch.core.baselines import (
    eig_tridiagonal_full_dc,
    eigvalsh_tridiagonal_bisect,
    eigvalsh_tridiagonal_full_discard,
    eigvalsh_tridiagonal_lazy,
    workspace_model_bisect,
    workspace_model_full,
    workspace_model_lazy,
    workspace_model_sterf,
)
from repro_torch.core.bisect import (SpectrumCertificate, certify_spectrum,
                                     eigvalsh_tridiagonal_range,
                                     refine_clusters, sturm_count)
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
    RANGE_EXECUTOR_TRACES,
    PlanKey,
    RangePlan,
    RangePlanKey,
    SolvePlan,
    clear_plan_cache,
    make_plan,
    make_range_plan,
    plan_cache_stats,
    plan_for_route,
    range_plan_for_route,
    resolve_range_route,
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
from repro_torch.core.secular import (boundary_rows_update,
                                      secular_eigenvalues, secular_solve,
                                      zhat_reconstruct)
from repro_torch.core.sterf import eigvalsh_tridiagonal_sterf
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
    "PlanKey", "RANGE_EXECUTOR_TRACES", "RangePlan", "RangePlanKey",
    "RoutedRequest", "SOLVE_COUNTER", "SolvePlan", "SolveRequest",
    "SolveResult", "SpectrumCertificate", "boundary_rows_update",
    "certify_spectrum", "clear_plan_cache", "dense_from_tridiag",
    "eig_tridiagonal_full_dc", "equilibrate", "eigvalsh_tridiagonal",
    "eigvalsh_tridiagonal_batch", "eigvalsh_tridiagonal_bisect",
    "eigvalsh_tridiagonal_br", "eigvalsh_tridiagonal_full_discard",
    "eigvalsh_tridiagonal_lazy", "eigvalsh_tridiagonal_range",
    "eigvalsh_tridiagonal_sterf", "execute_request", "gershgorin_bounds",
    "make_family",
    "make_family_batch", "make_plan", "make_range_plan", "plan_cache_stats",
    "plan_for_route", "range_plan_for_route", "refine_clusters",
    "resolve_range_route", "resolve_solve_route", "route_key_tuple",
    "route_request", "secular_eigenvalues", "secular_solve", "sturm_count",
    "validate_problem", "workspace_model", "workspace_model_bisect",
    "workspace_model_full", "workspace_model_lazy", "workspace_model_sterf",
    "zhat_reconstruct",
]
