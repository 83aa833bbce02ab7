"""The inputs of a run, made from its seed.

A configuration file names its ``generator``: the module
``generators/<generator>.py``, whose ``make(n, rng, params)`` returns one
problem's (d, e) as numpy arrays, with the configuration's ``params``.
Each problem draws from its own seed, derived from ``--seed``; the
harness never calls the program's generators.
"""

from __future__ import annotations

import numpy as np


def problem_rng(seed: int, stream: int, index: int) -> np.random.Generator:
    """The generator of problem ``index`` of ``stream``: its own seed,
    taken from the run's ``--seed`` (any non-negative integer)."""
    return np.random.default_rng(np.random.SeedSequence([seed, stream,
                                                         index]))


def make_problems(generator, params: dict, n: int, count: int, seed: int,
                  stream: int = 0):
    """``count`` problems of size n from the generator module
    ``generator``: stacked (count, n) d and (count, n - 1) e, float64."""
    ds, es = [], []
    for i in range(count):
        d, e = generator.make(n, problem_rng(seed, stream, i), params)
        ds.append(d)
        es.append(e)
    return (np.stack(ds).astype(np.float64),
            np.stack(es).astype(np.float64))
