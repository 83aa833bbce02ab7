"""The port's full-spectrum solve (repro_torch.core) on the CPU, held to
scipy and to the JAX package on the same numpy inputs.

Bar: 64 * eps * max(1, ||T||_inf) (tests/test_conformance.py's bar) against
scipy, and twice that against ``repro``.  The scipy reference is
``eigh_tridiagonal(..., lapack_driver="stebz")`` (bisection): at n = 4096
the default driver is itself off by tens of eps * ||T|| against an
extended-precision Sturm bisection, where stebz stays under one
(scripts/torch_reference_check.py, PERF.md).
"""

import functools

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.core import eigvalsh_tridiagonal_batch as j_batch  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro_torch.core import (EXECUTOR_TRACES, SOLVE_COUNTER,  # noqa: E402
                              FAMILIES, clear_plan_cache,
                              eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br, make_family,
                              make_plan)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import request as treq  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


EPS = np.finfo(np.float64).eps


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles one executable per shape here; XLA:CPU
    # keeps each one's memory mappings for the life of the process, and
    # the vm.max_map_count budget is shared with the worker's later test
    # modules (see tests/test_torch_bisect.py).
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _tinf(d, e):
    """||T||_inf: the largest absolute row sum."""
    row = np.abs(np.asarray(d, np.float64)).copy()
    if len(e):
        row[:-1] += np.abs(e)
        row[1:] += np.abs(e)
    return float(row.max())


def _bar(d, e):
    return 64 * EPS * max(1.0, _tinf(d, e))


def _scipy(d, e):
    if len(d) == 1:
        return np.asarray(d, np.float64)
    return sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                lapack_driver="stebz")


ALL = FAMILIES + ("glued_wilkinson",)
CASES = ([(f, n) for f in ALL for n in (1, 2, 3, 17, 25, 128, 257)]
         + [("wilkinson", n) for n in range(18, 25)])


@functools.lru_cache(maxsize=None)
def _jax_spectra(n, families, **kw):
    """The JAX package's spectra of ``families`` at size n (seed n), as one
    batched solve (one compile per size)."""
    probs = [make_family(f, n, seed=n) for f in families]
    D = np.stack([p[0] for p in probs])
    E = np.stack([p[1] for p in probs])
    lam = np.asarray(j_batch(D, E, **kw).eigenvalues)
    return dict(zip(families, lam))


@pytest.mark.parametrize("family,n", CASES)
def test_solve_vs_scipy_and_jax(family, n):
    d, e = make_family(family, n, seed=n)
    lam = eigvalsh_tridiagonal(d, e, device="cpu")
    assert lam.dtype == torch.float64 and lam.shape == (n,)
    lam = lam.numpy()
    np.testing.assert_allclose(lam, _scipy(d, e), rtol=0, atol=_bar(d, e))
    if family == "glued_wilkinson" and n > 32:
        # Its near-duplicate pole pairs need more than the JAX package's
        # 16 steps (ROADMAP Queue 3); it gets its converged budget.
        ref = _jax_spectra(n, (family,), niter=40)[family]
    else:
        ref = _jax_spectra(n, ALL if n in (1, 2, 3, 17, 25, 128, 257)
                           else (family,))[family]
    np.testing.assert_allclose(lam, ref, rtol=0, atol=2 * _bar(d, e))


@pytest.mark.parametrize("n", [128, 257])
def test_glued_wilkinson_converges_in_the_default_budget(n):
    """The cluster-lumped initial guess: at the default 16 steps the port
    meets the bar where the JAX package's iteration is still crawling."""
    d, e = make_family("glued_wilkinson", n, seed=n)
    ref = _scipy(d, e)
    lam = eigvalsh_tridiagonal(d, e, device="cpu").numpy()
    assert np.abs(lam - ref).max() <= _bar(d, e)
    jax_default = _jax_spectra(n, ALL)["glued_wilkinson"]
    assert np.abs(jax_default - ref).max() > 1e3 * _bar(d, e)


@pytest.mark.parametrize("B", [3, 4])
def test_batched_equals_looped_bitwise(B):
    fams = ("uniform", "glued_wilkinson", "clustered", "normal")
    probs = [make_family(fams[b], 100, seed=b) for b in range(B)]
    D = np.stack([p[0] for p in probs])
    E = np.stack([p[1] for p in probs])
    res = eigvalsh_tridiagonal_batch(D, E, device="cpu",
                                     return_boundary=True)
    for b in range(B):
        one = eigvalsh_tridiagonal_br(D[b], E[b], device="cpu",
                                      return_boundary=True)
        assert torch.equal(res.eigenvalues[b], one.eigenvalues)
        assert torch.equal(res.blo[b], one.blo)
        assert torch.equal(res.bhi[b], one.bhi)
    lam2 = eigvalsh_tridiagonal(D, E, device="cpu")
    assert torch.equal(lam2, res.eigenvalues)


def _host_pad(d, e, N):
    """Pad one problem to width N with decoupled sentinel blocks (the
    serving layer's staging form)."""
    n = len(d)
    sentinel = np.abs(d).max() + 2.0 * (np.abs(e).max() if n > 1 else 0.0) + 1
    return (np.concatenate([d, np.full(N - n, sentinel)]),
            np.concatenate([e, np.zeros(N - n)]))


def test_mixed_n_padded_batch_boundary_rows():
    """Different original sizes share one plan: each problem's boundary
    row n_b - 1 rides the tracked slot, rows match dense eigenvectors up
    to column sign, and the JAX package agrees on the same flush."""
    sizes = [50, 61, 64]
    probs = [make_family("uniform", n, seed=n) for n in sizes]
    padded = [_host_pad(d, e, 64) for d, e in probs]
    D = np.stack([p[0] for p in padded])
    E = np.stack([p[1] for p in padded])
    plan = make_plan(64, 3, leaf=16, return_boundary=True, device="cpu")
    res = plan.execute(D, E, orig_n=sizes)
    jres = jplan.make_plan(64, 3, leaf=16, return_boundary=True,
                           mesh=None).execute(D, E, orig_n=np.asarray(sizes))
    for b, (n, (d, e)) in enumerate(zip(sizes, probs)):
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        w, V = np.linalg.eigh(T)
        lam = res.eigenvalues[b, :n].numpy()
        np.testing.assert_allclose(lam, w, rtol=0, atol=_bar(d, e))
        np.testing.assert_allclose(
            lam, np.asarray(jres.eigenvalues)[b, :n], rtol=0,
            atol=2 * _bar(d, e))
        for got, row in ((res.blo, V[0]), (res.bhi, V[n - 1])):
            np.testing.assert_allclose(np.abs(got[b, :n].numpy()),
                                       np.abs(row), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [64, 100])
def test_single_boundary_rows_match_dense_eigh(n):
    d, e = make_family("uniform", n, seed=1)
    w, V = np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    res = eigvalsh_tridiagonal_br(d, e, leaf=8, return_boundary=True,
                                  device="cpu")
    assert np.max(np.abs(np.abs(res.blo.numpy()) - np.abs(V[0]))) < 1e-10
    assert np.max(np.abs(np.abs(res.bhi.numpy()) - np.abs(V[-1]))) < 1e-10


ROUTES = [("full", 1, 20, False), ("full", 1, 100, False),
          ("full", 1, 100, True), ("batch", 3, 100, False),
          ("batch", 5, 257, True), ("batch", 64, 33, False)]


@pytest.mark.parametrize("kind,B,n,rb", ROUTES)
def test_both_packages_route_to_the_same_bucket(kind, B, n, rb):
    d, e = make_family("normal", n, seed=2)
    if kind == "batch":
        d, e = np.tile(d, (B, 1)), np.tile(e, (B, 1))
    jr = jreq.route_request(jreq.SolveRequest(d=d, e=e, kind=kind,
                                              return_boundary=rb))
    tr = treq.route_request(treq.SolveRequest(d=d, e=e, kind=kind,
                                              return_boundary=rb,
                                              device="cpu"))
    jkey = jplan.plan_for_route(jr.route, jr.batch).key
    tkey = tplan.plan_for_route(tr.route, tr.batch).key
    assert tplan.route_key_tuple(tkey) == tplan.route_key_tuple(jkey)


def test_same_bucket_builds_one_executor_and_counts_solves():
    clear_plan_cache()
    d, e = make_family("uniform", 100, seed=3)
    with SOLVE_COUNTER.measure() as w:
        eigvalsh_tridiagonal(d, e, device="cpu")
        builds = EXECUTOR_TRACES.count
        eigvalsh_tridiagonal(d[:97], e[:96], device="cpu")   # same bucket
    assert EXECUTOR_TRACES.count == builds == 1
    assert w.count == 2
    assert tplan.plan_cache_stats()["hits"] == 1


def test_equilibration_is_exact():
    d, e = make_family("normal", 60, seed=4)
    base = eigvalsh_tridiagonal(d, e, device="cpu")
    big = eigvalsh_tridiagonal(d * 2.0 ** 600, e * 2.0 ** 600, device="cpu")
    assert torch.equal(big, base * 2.0 ** 600)


def test_float32_solve():
    d, e = make_family("uniform", 128, seed=5)
    lam = eigvalsh_tridiagonal(d.astype(np.float32), e.astype(np.float32),
                               device="cpu")
    assert lam.dtype == torch.float32
    bar = 64 * np.finfo(np.float32).eps * max(1.0, _tinf(d, e))
    np.testing.assert_allclose(lam.numpy(), _scipy(d, e), rtol=0, atol=bar)


@pytest.mark.parametrize("kw", [dict(mesh=2), dict(compress_halo=True)])
def test_later_slices_raise_not_implemented(kw):
    d, e = make_family("uniform", 40, seed=6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eigvalsh_tridiagonal(d, e, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(method="sterf"), dict(method="lazy"),
                                dict(method="eigh"), dict(method="full"),
                                dict(fused=False)])
def test_comparison_points_match_repro(kw):
    """The baselines and the two-pass conquer, once NotImplementedError in
    the port: within the bar of ``repro``'s same call and of scipy."""
    d, e = make_family("uniform", 40, seed=6)
    lam = eigvalsh_tridiagonal(d, e, device="cpu", **kw).numpy()
    np.testing.assert_allclose(lam, _scipy(d, e), rtol=0, atol=_bar(d, e))
    np.testing.assert_allclose(lam, np.asarray(jreq.execute_request(
        jreq.SolveRequest(d=d, e=e, method=kw.get("method", "br"),
                          knobs={k: v for k, v in kw.items()
                                 if k != "method"})).eigenvalues),
        rtol=0, atol=_bar(d, e))


def test_invalid_input_is_rejected_at_the_front_door():
    from repro_torch.core import InvalidInputError
    d, e = make_family("uniform", 40, seed=7)
    d[3] = np.nan
    with pytest.raises(InvalidInputError, match="index 3"):
        eigvalsh_tridiagonal(d, e, device="cpu")
