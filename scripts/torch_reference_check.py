#!/usr/bin/env python3
"""Accuracy probes behind PERF.md's reference notes (CPU only).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_reference_check.py \
        [drivers] [crawl] [mixed_rounds] [sterf_growth]

(all four probes when none is named)

1. scipy's reference drivers at n = 4096: for the uniform and clustered
   families (seed 0), the error of ``eigh_tridiagonal``'s default driver,
   of its ``stebz`` driver and of the port (``device="cpu"``) at the
   eigenvalue where the two drivers disagree most, against a Sturm-count
   bisection in extended precision (numpy longdouble).
2. The secular crawl on glued Wilkinson (ROADMAP Queue 3): the JAX
   package's and the port's max error against ``stebz`` at n = 128 and
   257 (seed 0), default knobs, and the JAX package with niter = 40.
3. The mixed-precision refinement on glued Wilkinson (ROADMAP Queue 3):
   the JAX package's ``precision="mixed"`` max error against ``stebz``
   and its refine rounds at n = 256, 512 and 2048 (seed 1), and the
   port's at n = 256 and 512 (the port re-solves lanes its last round
   could not certify).
4. QL's error growth (ROADMAP Queue 3 item 5): the JAX package's
   ``method="sterf"`` and the port's plain QL loop (``device="cpu"``) on
   the uniform family (seed 100: ``chip_smoke.py``'s n = 4096 problem)
   at n = 1024 and 4096, against ``stebz``, with each error over sqrt(n).

Errors are printed in units of eps * max(1, ||T||_inf).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

EPS = float(np.finfo(np.float64).eps)


def _unit(d, e):
    row = np.abs(d).copy()
    row[:-1] += np.abs(e)
    row[1:] += np.abs(e)
    return EPS * max(1.0, float(row.max()))


def _count_below(d, e2, x):
    """Number of eigenvalues below x (Sturm sequence in longdouble)."""
    q = d[0] - x
    c = int(q < 0)
    tiny = np.longdouble(1e-300)
    for i in range(1, len(d)):
        q = (d[i] - x) - e2[i - 1] / (q if q != 0 else tiny)
        c += int(q < 0)
    return c


def _exact(d, e, k, lo, hi):
    """Eigenvalue k by longdouble bisection inside [lo, hi]."""
    dl = d.astype(np.longdouble)
    e2 = e.astype(np.longdouble) ** 2
    lo, hi = np.longdouble(lo), np.longdouble(hi)
    for _ in range(90):
        mid = (lo + hi) / 2
        if _count_below(dl, e2, mid) > k:
            hi = mid
        else:
            lo = mid
    return (lo + hi) / 2


def drivers():
    from repro_torch.core import eigvalsh_tridiagonal, make_family
    for fam in ("uniform", "clustered"):
        d, e = make_family(fam, 4096, seed=0)
        default = sla.eigh_tridiagonal(d, e, eigvals_only=True)
        stebz = sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                     lapack_driver="stebz")
        port = eigvalsh_tridiagonal(d, e, device="cpu").numpy()
        u = _unit(d, e)
        k = int(np.argmax(np.abs(default - stebz)))
        vals = (default[k], stebz[k], port[k])
        ex = _exact(d, e, k, min(vals) - 1e-12, max(vals) + 1e-12)
        print(f"{fam} n=4096 seed 0, eigenvalue {k}: error of the default "
              f"driver {float((default[k] - ex) / np.longdouble(u)):.3f}, "
              f"stebz {float((stebz[k] - ex) / np.longdouble(u)):.3f}, "
              f"port {float((port[k] - ex) / np.longdouble(u)):.3f}; "
              f"max |port - stebz| {np.abs(port - stebz).max() / u:.2f}")


def crawl():
    import jax
    jax.config.update("jax_enable_x64", True)
    from repro.core import eigvalsh_tridiagonal as jax_eig
    from repro_torch.core import eigvalsh_tridiagonal, make_family
    for n in (128, 257):
        d, e = make_family("glued_wilkinson", n, seed=0)
        ref = sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                   lapack_driver="stebz")
        u = _unit(d, e)
        errs = {
            "jax": np.asarray(jax_eig(d, e)),
            "jax niter=40": np.asarray(jax_eig(d, e, niter=40)),
            "port": eigvalsh_tridiagonal(d, e, device="cpu").numpy()}
        print(f"glued_wilkinson n={n} seed 0, max error vs stebz: "
              + ", ".join(f"{k} {np.abs(v - ref).max() / u:.3g}"
                          for k, v in errs.items()))


def mixed_rounds():
    import jax
    jax.config.update("jax_enable_x64", True)
    from repro.core import SOLVE_COUNTER as JAX_COUNTER
    from repro.core import eigvalsh_tridiagonal as jax_eig
    from repro_torch.core import (SOLVE_COUNTER, SolveRequest,
                                  execute_request, make_family)
    for n in (256, 512, 2048):
        d, e = make_family("glued_wilkinson", n, seed=1)
        ref = sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                   lapack_driver="stebz")
        u = _unit(d, e)
        with JAX_COUNTER.measure(refinement=True) as w:
            lam = np.asarray(jax_eig(d, e, precision="mixed"))
        line = (f"glued_wilkinson n={n} seed 1, precision='mixed': jax max "
                f"error vs stebz {np.abs(lam - ref).max() / u:.4g} after "
                f"{w.refinement_stats['max_rounds']} refine round(s)")
        if n <= 512:
            with SOLVE_COUNTER.measure(refinement=True) as w:
                res = execute_request(SolveRequest(
                    d=d, e=e, knobs={"precision": "mixed"}, device="cpu"))
            lam = res.eigenvalues.numpy()
            line += (f"; port {np.abs(lam - ref).max() / u:.4g} after "
                     f"{w.refinement_stats['max_rounds']} round(s), "
                     f"escalations "
                     f"{(res.diagnostics or {}).get('escalations', 'none')}")
        print(line)


def sterf_growth():
    import time

    import jax
    jax.config.update("jax_enable_x64", True)
    from repro.core import eigvalsh_tridiagonal as jax_eig
    from repro_torch.core import eigvalsh_tridiagonal, make_family
    for n in (1024, 4096):
        d, e = make_family("uniform", n, seed=100)
        ref = sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                   lapack_driver="stebz")
        u = _unit(d, e)
        line = f"sterf uniform n={n} seed 100, max error vs stebz:"
        for name, solve in (
                ("jax", lambda: np.asarray(jax_eig(d, e, method="sterf"))),
                ("port", lambda: eigvalsh_tridiagonal(
                    d, e, method="sterf", device="cpu").numpy())):
            t = time.perf_counter()
            err = np.abs(solve() - ref).max() / u
            line += (f" {name} {err:.2f} ({err / np.sqrt(n):.3f} sqrt(n), "
                     f"{time.perf_counter() - t:.1f} s)")
        print(line, flush=True)


if __name__ == "__main__":
    import sys
    probes = {f.__name__: f for f in (drivers, crawl, mixed_rounds,
                                      sterf_growth)}
    for name in sys.argv[1:] or probes:
        probes[name]()
