"""Glued Wilkinson matrices: copies of the W^+ block of odd size
``block`` glued by couplings of ``glue``.  A frozen copy of the
``"glued_wilkinson"`` branch of
``src/repro_torch/core/tridiag.py::make_family``.  The matrix has no
randomness of its own, so each problem is shifted by sigma ~ U[-shift,
shift] and e takes random signs (a signature similarity): neither
changes the block structure or which poles deflate."""

import numpy as np


def make(n: int, rng, params: dict):
    blk = min(params["block"], n)
    blk -= (blk % 2 == 0)           # odd Wilkinson block size
    ib = np.arange(1, blk + 1, dtype=np.float64)
    db = np.abs(ib - 1 - (blk - 1) / 2.0)
    d = np.tile(db, n // blk + 1)[:n]
    e = np.ones(n - 1)
    e[blk - 1::blk] = params["glue"]
    sigma = rng.uniform(-params["shift"], params["shift"])
    signs = rng.choice(np.array([-1.0, 1.0]), n - 1)
    return d + sigma, e * signs
