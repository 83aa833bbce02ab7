"""The port's Sturm-count path (repro_torch.core.bisect) on the CPU, held to
the JAX package and to scipy on the same numpy inputs.

  * Sturm counts are integers: the port's plain version equals
    ``repro``'s XLA scan, both oracles (``kernels.ref.sturm_count_ref``)
    and ``repro``'s Pallas kernel in interpret mode, exactly.
  * The count + derivative sweep: counts exact, the derivative sum within
    1e-10 relative of ``repro``'s (XLA on the CPU may contract the
    multiply-add; the port never does).
  * Range, edges and bisect solves: within 8 eps ||T|| of the port's full
    BR solve and of ``repro``'s range solve (the range API's contract),
    within 64 eps ||T|| of scipy's ``stebz`` (the conformance bar);
    ``select="v"`` hit counts equal ``repro``'s.
  * The host loop that replaces ``lax.while_loop`` gives the same bits
    whether it checks convergence every trip or every 8 trips.
"""

import functools

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bisect as jbis  # noqa: E402
from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.core import eigvalsh_tridiagonal as j_eig  # noqa: E402
from repro.core import eigvalsh_tridiagonal_range as j_range  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sturm_count import sturm_count_pallas_batch  # noqa: E402
from repro_torch.core import (FAMILIES, RANGE_EXECUTOR_TRACES,  # noqa: E402
                              InvalidInputError, SolveRequest,
                              eigvalsh_tridiagonal, eigvalsh_tridiagonal_br,
                              eigvalsh_tridiagonal_range, execute_request,
                              make_family, make_family_batch,
                              make_range_plan, sturm_count)
from repro_torch.core import bisect as tbis  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


EPS = np.finfo(np.float64).eps
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles many one-off executables here (range,
    # certify and refine shapes, Pallas interpret); XLA:CPU keeps each
    # one's memory mappings for the life of the process, and the
    # vm.max_map_count budget is shared with the worker's later test
    # modules (tests/test_mixed.py releases its own the same way).
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _tinf(d, e):
    row = np.abs(np.asarray(d, np.float64)).copy()
    if len(e):
        row[:-1] += np.abs(e)
        row[1:] += np.abs(e)
    return float(row.max())


def _bar(d, e, k):
    return k * EPS * max(1.0, _tinf(d, e))


@functools.lru_cache(maxsize=None)
def _stebz(family, n, seed):
    d, e = make_family(family, n, seed=seed)
    if n == 1:
        return d.astype(np.float64)
    return sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                lapack_driver="stebz")


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------ Sturm counts


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("B,n,S", [(1, 8, 4), (4, 64, 130), (3, 1, 5),
                                   (2, 257, 1)])
def test_sturm_counts_exact_against_repro_and_oracles(B, n, S, dtype):
    rng = np.random.default_rng(B * 1000 + n)
    d = rng.standard_normal((B, n)).astype(dtype)
    e2 = (rng.uniform(0.05, 0.5, (B, max(n - 1, 0))) ** 2).astype(dtype)
    shifts = rng.uniform(-3, 3, (B, S)).astype(dtype)
    piv_j = jbis._pivot_floor(jnp.asarray(e2), jnp.dtype(dtype))
    piv_t = tbis._pivot_floor(_t(e2))
    np.testing.assert_array_equal(piv_t.numpy(), np.asarray(piv_j))
    got = tbis.sturm_count_plain(_t(d), _t(e2), _t(shifts), piv_t).numpy()
    xla = np.asarray(jbis.sturm_count_xla(jnp.asarray(d), jnp.asarray(e2),
                                          jnp.asarray(shifts), piv_j))
    pallas = np.asarray(sturm_count_pallas_batch(
        jnp.asarray(d), jnp.asarray(e2), jnp.asarray(shifts), piv_j,
        shift_block=32, interpret=True))
    oracle = tref.sturm_count_ref(d, e2, shifts, piv_t).numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, np.asarray(jref.sturm_count_ref(
        d, e2, shifts, np.asarray(piv_j))))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sturm_counts_on_eigenvalues_and_zero_couplings(dtype):
    """Shifts placed exactly on eigenvalues (the pivot floor decides) and
    zero off-diagonals (every pivot is d_i - x)."""
    d0, e0 = make_family("normal", 48, seed=2)
    lam = np.linalg.eigvalsh(np.diag(d0) + np.diag(e0, 1) + np.diag(e0, -1))
    d = np.stack([d0, d0, [3.0, -1.0, 2.0, -1.0] * 12]).astype(dtype)
    e2 = np.stack([e0 * e0, np.zeros(47), np.zeros(47)]).astype(dtype)
    shifts = np.stack([lam, np.sort(d0), np.linspace(-2, 10, 48)]
                      ).astype(dtype)
    piv_j = jbis._pivot_floor(jnp.asarray(e2), jnp.dtype(dtype))
    got = tbis.sturm_count_plain(_t(d), _t(e2), _t(shifts),
                                 tbis._pivot_floor(_t(e2))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbis.sturm_count_xla(
        jnp.asarray(d), jnp.asarray(e2), jnp.asarray(shifts), piv_j)))
    np.testing.assert_array_equal(got, np.asarray(sturm_count_pallas_batch(
        jnp.asarray(d), jnp.asarray(e2), jnp.asarray(shifts), piv_j,
        interpret=True)))
    np.testing.assert_array_equal(got[1], np.arange(1, 49))


def test_count_and_newton_against_repro():
    rng = np.random.default_rng(5)
    B, n, S = 3, 80, 20
    d = rng.standard_normal((B, n))
    e2 = rng.uniform(0.05, 0.5, (B, n - 1)) ** 2
    x = rng.uniform(-2, 2, (B, S))
    piv_j = jbis._pivot_floor(jnp.asarray(e2), jnp.float64)
    cj, sj = jbis._count_and_newton(jnp.asarray(d), jnp.asarray(e2),
                                    jnp.asarray(x), piv_j)
    ct, st = tbis._count_and_newton(_t(d), _t(e2), _t(x),
                                    tbis._pivot_floor(_t(e2)))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-10,
                               atol=0)
    assert torch.equal(ct, tbis.sturm_count_plain(
        _t(d), _t(e2), _t(x), tbis._pivot_floor(_t(e2))))


def test_sturm_count_matches_spectrum():
    d, e = make_family("normal", 96, seed=96)
    ref = _stebz("normal", 96, 96)
    mids = 0.5 * (ref[:-1] + ref[1:])
    np.testing.assert_array_equal(sturm_count(d, e, mids, device=CPU),
                                  np.arange(1, 96))
    assert int(sturm_count(d, e, ref[-1] + 1.0, device=CPU)) == 96
    assert int(sturm_count(d, e, ref[0] - 1.0, device=CPU)) == 0
    with pytest.raises(InvalidInputError, match="1-D"):
        sturm_count(np.ones((2, 12)), np.ones((2, 11)), 0.0, device=CPU)
    bad = d.copy()
    bad[4] = np.inf
    with pytest.raises(InvalidInputError, match="index 4"):
        sturm_count(bad, e, 0.0, device=CPU)


# ------------------------------------------------------------ range solves


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("window", [(0, 7), (60, 67), (120, 127)])
def test_range_matches_full_br_repro_and_stebz(family, window):
    n, (il, iu) = 128, window
    d, e = make_family(family, n, seed=n)
    got = eigvalsh_tridiagonal_range(d, e, il=il, iu=iu, device=CPU)
    assert got.dtype == torch.float64 and got.shape == (iu - il + 1,)
    got = got.numpy()
    full = eigvalsh_tridiagonal_br(d, e, leaf=8, device=CPU).eigenvalues
    np.testing.assert_allclose(got, full.numpy()[il:iu + 1], rtol=0,
                               atol=_bar(d, e, 8))
    np.testing.assert_allclose(got, np.asarray(j_range(d, e, il=il, iu=iu)),
                               rtol=0, atol=_bar(d, e, 8))
    np.testing.assert_allclose(got, _stebz(family, n, n)[il:iu + 1],
                               rtol=0, atol=_bar(d, e, 64))


@pytest.mark.parametrize("family,n", [("uniform", 257),
                                      ("glued_wilkinson", 129)])
def test_bisect_method_full_spectrum(family, n):
    d, e = make_family(family, n, seed=n)
    got = eigvalsh_tridiagonal(d, e, method="bisect", device=CPU).numpy()
    np.testing.assert_allclose(got, _stebz(family, n, n), rtol=0,
                               atol=_bar(d, e, 64))
    np.testing.assert_allclose(got, np.asarray(j_eig(d, e,
                                                     method="bisect")),
                               rtol=0, atol=_bar(d, e, 8))


@pytest.mark.parametrize("family", ["uniform", "normal", "wilkinson"])
def test_select_by_value_hits_match_repro(family):
    n = 128
    d, e = make_family(family, n, seed=n)
    ref = _stebz(family, n, n)
    vl = 0.5 * (ref[20] + ref[21])
    vu = 0.5 * (ref[90] + ref[91])
    got = eigvalsh_tridiagonal_range(d, e, select="v", vl=vl, vu=vu,
                                     device=CPU).numpy()
    want = np.asarray(j_range(d, e, select="v", vl=vl, vu=vu))
    assert got.shape == want.shape
    start = int(sturm_count(d, e, vl, device=CPU))
    np.testing.assert_allclose(got, ref[start:start + len(got)], rtol=0,
                               atol=_bar(d, e, 64))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bar(d, e, 8))


def test_select_by_value_empty_window():
    d, e = make_family("uniform", 64, seed=64)
    top = float(_stebz("uniform", 64, 64)[-1])
    got = eigvalsh_tridiagonal_range(d, e, select="v", vl=top + 1.0,
                                     vu=top + 2.0, device=CPU)
    assert got.shape == (0,) and got.dtype == torch.float64


def test_range_batched_equals_looped_bitwise():
    D, E = make_family_batch("normal", 100, 5, seed0=1)
    got = eigvalsh_tridiagonal_range(D, E, il=90, iu=99, device=CPU)
    assert got.shape == (5, 10)
    for b in range(5):
        assert torch.equal(got[b], eigvalsh_tridiagonal_range(
            D[b], E[b], il=90, iu=99, device=CPU))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 5e-5)])
def test_range_dtypes(dtype, tol):
    d, e = make_family("uniform", 128, seed=128, dtype=dtype)
    got = eigvalsh_tridiagonal_range(d, e, il=120, iu=127, device=CPU)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    want = np.asarray(j_range(d, e, il=120, iu=127))
    np.testing.assert_allclose(got.numpy().astype(np.float64),
                               _stebz("uniform", 128, 128)[120:], rtol=0,
                               atol=tol * max(1.0, _tinf(d, e)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=8 * np.finfo(dtype).eps
                               * max(1.0, _tinf(d, e)))


def test_range_window_shift_builds_nothing():
    d, e = make_family("uniform", 200, seed=0)
    eigvalsh_tridiagonal_range(d, e, il=0, iu=5, device=CPU)
    with RANGE_EXECUTOR_TRACES.measure() as w:
        eigvalsh_tridiagonal_range(d, e, il=100, iu=105, device=CPU)
        eigvalsh_tridiagonal_range(d, e, il=194, iu=199, device=CPU)
        eigvalsh_tridiagonal_range(d, e, il=0, iu=7, device=CPU)
    assert w.count == 0


def test_range_plan_bucketing():
    p1 = make_range_plan(333, 5, device=CPU)
    assert make_range_plan(333, 8, device=CPU) is p1
    assert p1.key.k_bucket == 8
    assert make_range_plan(333, 9, device=CPU).key.k_bucket == 16
    assert make_range_plan(333, 5, batch=3, device=CPU).key.batch_bucket == 4


def test_range_n1_and_clustered_duplicates():
    got = eigvalsh_tridiagonal_range(np.array([4.5]), np.zeros(0), il=0,
                                     iu=0, device=CPU)
    np.testing.assert_array_equal(got.numpy(), [4.5])
    d, e = np.ones(64), np.full(63, 1e-3)
    ref = sla.eigh_tridiagonal(d, e, eigvals_only=True, lapack_driver="stebz")
    got = eigvalsh_tridiagonal_range(d, e, il=0, iu=63, device=CPU).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(d, e, 64))
    np.testing.assert_allclose(got, np.asarray(j_range(d, e, il=0, iu=63)),
                               rtol=0, atol=_bar(d, e, 8))


def test_range_validation():
    d, e = make_family("uniform", 32, seed=0)
    kw = dict(device=CPU)
    with pytest.raises(ValueError, match="index range"):
        eigvalsh_tridiagonal_range(d, e, il=5, iu=3, **kw)
    with pytest.raises(ValueError, match="index range"):
        eigvalsh_tridiagonal_range(d, e, il=0, iu=32, **kw)
    with pytest.raises(ValueError, match="requires il and iu"):
        eigvalsh_tridiagonal_range(d, e, **kw)
    with pytest.raises(ValueError, match="vl < vu"):
        eigvalsh_tridiagonal_range(d, e, select="v", vl=1.0, vu=1.0, **kw)
    with pytest.raises(ValueError, match="single problems"):
        eigvalsh_tridiagonal_range(np.stack([d, d]), np.stack([e, e]),
                                   select="v", vl=0.0, vu=1.0, **kw)
    with pytest.raises(ValueError, match="select"):
        eigvalsh_tridiagonal_range(d, e, select="x", il=0, iu=1, **kw)
    with pytest.raises(TypeError, match="unexpected"):
        execute_request(SolveRequest(d=d, e=e, kind="range", il=0, iu=1,
                                     knobs={"leaf": 8}, device=CPU))


def test_range_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, e = make_family("uniform", 40, seed=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigvalsh_tridiagonal_range(d, e, il=0, iu=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigvalsh_tridiagonal(d, e, method="bisect")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sturm_count(d, e, 0.0)


@pytest.mark.parametrize("kind", ["slq"])
def test_slq_still_raises_naming_its_item(kind):
    """kind='slq' runs now: it routes as the JAX package's slq does, to a
    boundary-row batch key with the same fields, and only with
    method='br' and stacked input."""
    from repro_torch.core import route_request
    D, E = make_family_batch("uniform", 40, 3, seed0=6)
    knobs = {"leaf": 8}
    got = route_request(SolveRequest(d=D, e=E, kind=kind, knobs=knobs,
                                     device=CPU)).route
    want = jreq.route_request(jreq.SolveRequest(d=D, e=E, kind=kind,
                                                knobs=knobs)).route
    fields = ("padded_n", "leaf", "batch_bucket", "dtype", "chunk", "niter",
              "use_zhat", "return_boundary", "tol_factor",
              "stream_threshold", "deflate_budget", "resident_threshold",
              "fused", "precision", "refine_tol", "certify")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.return_boundary
    res = execute_request(SolveRequest(d=D, e=E, kind=kind, knobs=knobs,
                                       device=CPU))
    assert res.blo is not None and res.blo.shape == D.shape
    with pytest.raises(TypeError, match="slq"):
        execute_request(SolveRequest(d=D, e=E, kind=kind, method="sterf",
                                     device=CPU))
    with pytest.raises(ValueError, match="stacked"):
        execute_request(SolveRequest(d=D[0], e=E[0], kind=kind, device=CPU))


# ------------------------------------------------------------------ edges


def test_edges_match_repro_and_range():
    D, E = make_family_batch("uniform", 96, 3, seed0=4)
    k = 4
    res = execute_request(SolveRequest(d=D, e=E, kind="edges",
                                       knobs={"k": k}, device=CPU))
    got = res.eigenvalues.numpy()
    assert got.shape == (6, k)
    want = np.asarray(jreq.execute_request(jreq.SolveRequest(
        d=D, e=E, kind="edges", knobs={"k": k})).eigenvalues)
    bar = max(_bar(D[b], E[b], 8) for b in range(3))
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)
    for b in range(3):
        lo = eigvalsh_tridiagonal_range(D[b], E[b], il=0, iu=k - 1,
                                        device=CPU)
        hi = eigvalsh_tridiagonal_range(D[b], E[b], il=96 - k, iu=95,
                                        device=CPU)
        assert torch.equal(res.eigenvalues[b], lo)
        assert torch.equal(res.eigenvalues[3 + b], hi)


# ------------------------------------------------------ host-loop schedule


@pytest.mark.parametrize("family", ["uniform", "glued_wilkinson"])
def test_convergence_check_interval_changes_no_bits(family, monkeypatch):
    """Converged brackets freeze, so checking every trip and checking
    every 8 trips give identical results -- and never more than maxiter
    trips."""
    D, E = make_family_batch(family, 90, 3, seed0=2)
    calls = []
    real = tbis._CHECK_EVERY

    def run(every, maxiter=None):
        monkeypatch.setattr(tbis, "_CHECK_EVERY", every)
        calls.clear()
        return eigvalsh_tridiagonal_range(D, E, il=3, iu=40,
                                          maxiter=maxiter, device=CPU)

    assert real == 8
    assert torch.equal(run(1), run(8))
    assert torch.equal(run(1, maxiter=13), run(8, maxiter=13))
    count = tbis.sturm_count_plain
    monkeypatch.setattr(tbis, "sturm_count_plain",
                        lambda *a: calls.append(1) or count(*a))
    run(8, maxiter=13)
    assert len(calls) == 13
