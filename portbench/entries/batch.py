"""``eigvalsh_tridiagonal`` on a stacked (batch, n) pool entry: every
eigenvalue of each of its problems.  The traffic's ``knobs`` go to the
entry point as they are."""

import numpy as np


def call(work, i):
    p = i % work.pool
    return work.core.eigvalsh_tridiagonal(work.d[p], work.e[p],
                                          device=work.device, **work.knobs)


def indices(work, i):
    return np.broadcast_to(np.arange(work.n), (work.per_call, work.n))


def model(work):
    """The program's model of the solve's device memory."""
    m = work.core.workspace_model(work.n, batch=work.per_call)
    return (f"workspace_model {m['total_bytes'] / 2**20:.3f} MiB "
            f"({m['model']})")
