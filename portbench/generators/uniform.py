"""The paper's Section 5.1 uniform family: d ~ U[d_low, d_high],
e ~ U[e_low, e_high].  A frozen copy of the ``"uniform"`` branch of
``src/repro_torch/core/tridiag.py::make_family``, with its bounds read
from the configuration's ``params``."""


def make(n: int, rng, params: dict):
    d = rng.uniform(params["d_low"], params["d_high"], n)
    e = rng.uniform(params["e_low"], params["e_high"], n - 1)
    return d, e
