"""``eigvalsh_tridiagonal_range`` for the k eigenvalues [s_i, s_i + k - 1]
of one (n,) problem, s_i drawn from the seed for each call from
``starts`` draws of U{0, ..., n - k}.  The traffic's ``knobs`` go to the
entry point as they are."""

import numpy as np


def prepare(work):
    rng = np.random.default_rng(np.random.SeedSequence([work.seed, 1]))
    work.starts = rng.integers(0, work.n - work.k + 1,
                               size=int(work.traffic["starts"]))


def first(work, i):
    return int(work.starts[i % len(work.starts)])


def call(work, i):
    p, il = i % work.pool, first(work, i)
    return work.core.eigvalsh_tridiagonal_range(
        work.d[p, 0], work.e[p, 0], il=il, iu=il + work.k - 1,
        device=work.device, **work.knobs)


def indices(work, i):
    return (first(work, i) + np.arange(work.k))[None]


def model(work):
    """The program's model of the range solve's device memory."""
    m = work.core.workspace_model_bisect(work.n, work.k, batch=1)
    return (f"workspace_model_bisect {m['persistent_bytes'] / 2**20:.3f}"
            f" MiB ({m['model']})")
