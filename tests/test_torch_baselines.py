"""The port's comparison points (repro_torch.core.sterf, .baselines and the
two-pass conquer) on the CPU, held to the JAX package and to scipy on the
same numpy inputs.

  * sterf (implicit-shift QL): within 64 eps ||T||_inf of ``repro``'s
    sterf and of scipy's ``stebz`` (the conformance bar; hypot differs
    between math libraries, so the two QL runs are not bitwise).
  * lazy-replay and full-vector D&C (leaf = 8): within 64 eps ||T||_inf of
    ``repro``'s; full's Q orthogonal with A Q = Q diag(lam) as in
    tests/test_core_baselines.py.  Their r = K levels run the two-pass
    conquer in the port and the fused/resident path in ``repro``: equal to
    rounding, not bitwise.
  * workspace models: equal to ``repro``'s, exactly.
  * ``fused=False``: within the bar of ``repro``'s ``fused=False`` and of
    the port's fused solve.
  * the plain two-pass functions against ``repro.core.secular``'s at
    tests/test_kernels.py's shapes and tolerances; an exact zero
    denominator contributes the pole's weight in both.
  * the float32 weight repair (ROADMAP Queue 3 item 2).
"""

import functools

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbl  # noqa: E402
from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.core import eigvalsh_tridiagonal as j_eig  # noqa: E402
from repro.core import secular as jsec  # noqa: E402
from repro.core.sterf import eigvalsh_tridiagonal_sterf as j_sterf  # noqa: E402
from repro_torch.core import (METHODS, SolveRequest,  # noqa: E402
                              dense_from_tridiag, eig_tridiagonal_full_dc,
                              eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_bisect,
                              eigvalsh_tridiagonal_lazy,
                              eigvalsh_tridiagonal_sterf, execute_request,
                              make_family)
from repro_torch.core import baselines as tbl  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402

EPS = np.finfo(np.float64).eps
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles one executable per shape here; XLA:CPU
    # keeps each one's memory mappings for the life of the process (see
    # tests/test_torch_bisect.py).
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _tinf(d, e):
    row = np.abs(np.asarray(d, np.float64)).copy()
    if len(e):
        row[:-1] += np.abs(e)
        row[1:] += np.abs(e)
    return float(row.max())


def _bar(d, e, k=64):
    return k * EPS * max(1.0, _tinf(d, e))


@functools.lru_cache(maxsize=None)
def _stebz(family, n, seed):
    d, e = make_family(family, n, seed=seed)
    return sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                lapack_driver="stebz")


# ---- sterf -----------------------------------------------------------------

@pytest.mark.parametrize("family", ["uniform", "toeplitz", "clustered"])
@pytest.mark.parametrize("n", [16, 100])
def test_sterf_matches_repro_and_lapack(family, n):
    d, e = make_family(family, n, seed=n)
    got = eigvalsh_tridiagonal_sterf(d, e, device=CPU)
    assert got.dtype == torch.float64 and got.shape == (n,)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(j_sterf(d, e)), rtol=0,
                               atol=_bar(d, e))
    np.testing.assert_allclose(got, _stebz(family, n, n), rtol=0,
                               atol=_bar(d, e))


def test_sterf_float32_and_tiny_sizes():
    d, e = make_family("normal", 60, seed=2)
    got = eigvalsh_tridiagonal_sterf(d, e, dtype=torch.float32, device=CPU)
    assert got.dtype == torch.float32
    bar = 64 * np.finfo(np.float32).eps * max(1.0, _tinf(d, e))
    np.testing.assert_allclose(got.numpy(), _stebz("normal", 60, 2), rtol=0,
                               atol=bar)
    assert torch.equal(eigvalsh_tridiagonal_sterf(d[:1], e[:0], device=CPU),
                       torch.tensor(d[:1]))
    two = eigvalsh_tridiagonal_sterf(d[:2], e[:1], device=CPU).numpy()
    np.testing.assert_allclose(two, np.linalg.eigvalsh(
        dense_from_tridiag(d[:2], e[:1])), rtol=0, atol=_bar(d, e))


# ---- lazy-replay and full-vector D&C -----------------------------------------

@pytest.mark.parametrize("family", ["uniform", "normal", "clustered"])
def test_lazy_replay_matches_repro(family):
    d, e = make_family(family, 128, seed=3)
    got = eigvalsh_tridiagonal_lazy(d, e, leaf=8, device=CPU).numpy()
    want = np.asarray(jbl.eigvalsh_tridiagonal_lazy(d, e, leaf=8))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bar(d, e))
    br = eigvalsh_tridiagonal(d, e, leaf=8, device=CPU).numpy()
    np.testing.assert_allclose(got, br, rtol=0, atol=_bar(d, e))


@pytest.mark.parametrize("n", [32, 96, 128])
def test_full_dc_eigenpairs_match_repro(n):
    """Full-vector D&C: A Q = Q diag(lam), Q orthogonal, the spectrum
    within the bar of ``repro``'s."""
    d, e = make_family("uniform", n, seed=n)
    lam, Q = eig_tridiagonal_full_dc(d, e, leaf=8, device=CPU)
    lam, Q = lam.numpy(), Q.numpy()
    A = dense_from_tridiag(d, e)
    assert np.max(np.abs(Q.T @ Q - np.eye(n))) < 1e-10
    assert np.max(np.abs(A @ Q - Q * lam[None, :])) < 1e-9
    want, _ = jbl.eig_tridiagonal_full_dc(d, e, leaf=8)
    np.testing.assert_allclose(lam, np.asarray(want), rtol=0,
                               atol=_bar(d, e))


def test_baselines_on_a_padded_and_a_single_leaf_tree():
    d, e = make_family("normal", 100, seed=5)
    ref = _stebz("normal", 100, 5)
    for fn in (eigvalsh_tridiagonal_lazy, tbl.eigvalsh_tridiagonal_full_discard):
        for leaf in (8, 128):        # padded 100 -> 128; one leaf
            got = fn(d, e, leaf=leaf, device=CPU).numpy()
            assert got.shape == (100,)
            np.testing.assert_allclose(got, ref, rtol=0, atol=_bar(d, e))


@pytest.mark.parametrize("n", [1, 100, 1000, 4096, 5000])
def test_workspace_models_equal_repro(n):
    assert tbl.workspace_model_lazy(n) == jbl.workspace_model_lazy(n)
    assert tbl.workspace_model_full(n) == jbl.workspace_model_full(n)
    assert tbl.workspace_model_sterf(n) == jbl.workspace_model_sterf(n)
    assert tbl.workspace_model_bisect(n) == jbl.workspace_model_bisect(n)
    assert (tbl.workspace_model_lazy(n, leaf=8, itemsize=4)
            == jbl.workspace_model_lazy(n, leaf=8, itemsize=4))
    assert (tbl.workspace_model_bisect(n, k=7, batch=3)
            == jbl.workspace_model_bisect(n, k=7, batch=3))


@pytest.mark.parametrize("method", METHODS)
def test_all_methods_agree(method):
    """Every method through ``eigvalsh_tridiagonal`` vs scipy at n = 150,
    and vs ``repro``'s same method."""
    d, e = make_family("normal", 150, seed=150)
    got = eigvalsh_tridiagonal(d, e, method=method, device=CPU).numpy()
    np.testing.assert_allclose(got, _stebz("normal", 150, 150), rtol=0,
                               atol=_bar(d, e))
    np.testing.assert_allclose(got, np.asarray(j_eig(d, e, method=method)),
                               rtol=0, atol=_bar(d, e))


def test_bisect_baseline_equals_the_bisect_method():
    d, e = make_family("uniform", 90, seed=9)
    assert torch.equal(
        eigvalsh_tridiagonal_bisect(d, e, device=CPU),
        eigvalsh_tridiagonal(d, e, method="bisect", device=CPU))


@pytest.mark.parametrize("method", ["sterf", "lazy", "full", "eigh"])
def test_baselines_batch_certify_and_equilibrate(method):
    """Stacked inputs run one problem at a time; certify=True tallies every
    lane; an exact power-of-two scaling comes back exactly."""
    probs = [make_family("uniform", 70, seed=s) for s in range(3)]
    D = np.stack([p[0] for p in probs])
    E = np.stack([p[1] for p in probs])
    kw = {"leaf": 8} if method in ("lazy", "full") else {}
    lam = eigvalsh_tridiagonal(D, E, method=method, device=CPU, **kw)
    assert lam.shape == (3, 70)
    for b in range(3):
        np.testing.assert_allclose(lam[b].numpy(),
                                   _stebz("uniform", 70, b), rtol=0,
                                   atol=_bar(D[b], E[b]))
    res = execute_request(SolveRequest(d=D[0], e=E[0], method=method,
                                       certify=True, device=CPU))
    assert res.diagnostics["certified"] == res.diagnostics["lanes"] == 70
    big = eigvalsh_tridiagonal(D[0] * 2.0 ** 600, E[0] * 2.0 ** 600,
                               method=method, device=CPU, **kw)
    assert torch.equal(big, lam[0] * 2.0 ** 600)


# ---- fused=False: the two-pass conquer ------------------------------------

@pytest.mark.parametrize("family,n", [("glued_wilkinson", 128),
                                      ("uniform", 100), ("normal", 61)])
def test_fused_false_matches_repro_and_fused(family, n):
    d, e = make_family(family, n, seed=n)
    niter = 40 if family == "glued_wilkinson" else 16
    got = eigvalsh_tridiagonal(d, e, fused=False, leaf=8, niter=niter,
                               device=CPU).numpy()
    want = np.asarray(j_eig(d, e, fused=False, leaf=8, niter=niter))
    np.testing.assert_allclose(got, want, rtol=0, atol=_bar(d, e))
    fused = eigvalsh_tridiagonal(d, e, leaf=8, niter=niter,
                                 device=CPU).numpy()
    np.testing.assert_allclose(got, fused, rtol=0, atol=_bar(d, e))


def test_fused_false_batch_runs_the_plan_with_boundary_rows():
    probs = [make_family("uniform", 50, seed=s) for s in range(3)]
    D = np.stack([p[0] for p in probs])
    E = np.stack([p[1] for p in probs])
    from repro_torch.core import eigvalsh_tridiagonal_batch
    two = eigvalsh_tridiagonal_batch(D, E, fused=False, leaf=8,
                                     return_boundary=True, device=CPU)
    one = eigvalsh_tridiagonal_batch(D, E, leaf=8, return_boundary=True,
                                     device=CPU)
    for a, b in ((two.eigenvalues, one.eigenvalues), (two.blo, one.blo),
                 (two.bhi, one.bhi)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


# ---- the plain two-pass functions vs repro.core.secular ------------------

SHAPES = [(8, 8), (32, 17), (64, 64), (130, 101), (256, 1), (257, 256)]


def _problem(K, kprime, seed):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal(K))
    d[kprime:] += 10.0
    z = rng.standard_normal(K)
    z[kprime:] = 0.0
    z /= np.linalg.norm(z)
    return d, z, 0.7


def _solved(K, kprime, seed):
    d, z, rho = _problem(K, kprime, seed)
    o, t = jsec.secular_solve(jnp.asarray(d), jnp.asarray(z * z), rho,
                              kprime, niter=16)
    return d, z, rho, np.array(o), np.array(t)


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_zhat_matches_repro(K, kprime):
    d, z, rho, o, t = _solved(K, kprime, seed=4)
    want = jsec.zhat_reconstruct(jnp.asarray(d), jnp.asarray(z),
                                 jnp.asarray(o), jnp.asarray(t), kprime, rho)
    got = tsec.zhat_reconstruct(torch.tensor(d), torch.tensor(z),
                                torch.tensor(o), torch.tensor(t), kprime,
                                rho)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10,
                               rtol=1e-8)


@pytest.mark.parametrize("K,kprime", SHAPES)
@pytest.mark.parametrize("r", [1, 2, 4, "K"])
def test_plain_boundary_update_matches_repro(K, kprime, r):
    r = K if r == "K" else r
    d, z, rho, o, t = _solved(K, kprime, seed=3)
    R = np.random.default_rng(3).standard_normal((r, K))
    want = jsec.boundary_rows_update(jnp.asarray(R), jnp.asarray(d),
                                     jnp.asarray(z), jnp.asarray(o),
                                     jnp.asarray(t), kprime)
    got = tsec.boundary_rows_update(torch.tensor(R), torch.tensor(d),
                                    torch.tensor(z), torch.tensor(o),
                                    torch.tensor(t), kprime)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=1e-12)


def test_zero_denominator_contributes_the_weight():
    """Root 0 planted exactly on pole 0 (origin 0, tau 0): the active pole
    whose denominator is zero contributes z_0, as in ``repro``'s XLA path
    (its Pallas kernel and the dense oracle drop it instead)."""
    d, z, rho, o, t = _solved(64, 50, seed=7)
    o[0], t[0] = 0, 0.0
    R = np.random.default_rng(7).standard_normal((3, 64))
    want = np.asarray(jsec.boundary_rows_update(
        jnp.asarray(R), jnp.asarray(d), jnp.asarray(z), jnp.asarray(o),
        jnp.asarray(t), 50))
    got = tsec.boundary_rows_update(torch.tensor(R), torch.tensor(d),
                                    torch.tensor(z), torch.tensor(o),
                                    torch.tensor(t), 50).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=1e-12)
    y = z[:50] / np.where(d[:50] - d[0] == 0.0, 1.0, d[:50] - d[0])
    np.testing.assert_allclose(got[:, 0], R[:, :50] @ y / np.linalg.norm(y),
                               atol=1e-12, rtol=1e-12)


def test_f32_weights_stay_finite_where_poles_coincide():
    """ROADMAP Queue 3 item 2: chip_smoke.py's synthetic resident problem
    (seed 2050, K = 2048, kprime = 1536, r = 2, float32), lanes 14 and 21.
    Their poles 836/837 and 883/884 are 3.9e-9 and 2.1e-9 apart in float64
    and one value in float32, so the ratio product met 0/0 (NaN).  The
    weights are now finite, and the float32 solve matches the float64
    solve of the same (float32-rounded) problem: eigenvalues within
    tests/test_torch_secular.py's float32 tolerance (1e-13 scaled by
    eps32/eps64), weights and rows within tests/test_torch_kernels.py's
    (1e-12 and 1e-10 so scaled)."""
    rng = np.random.default_rng(2050)
    d = np.sort(rng.standard_normal((64, 2048)), axis=1)[[14, 21]]
    d[:, 1536:] += 10.0
    z = rng.standard_normal((64, 2048))[[14, 21]]
    z[:, 1536:] = 0.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    d32 = torch.tensor(d, dtype=torch.float32)
    z32 = torch.tensor(z, dtype=torch.float32)
    R = torch.tensor(np.random.default_rng(2050).standard_normal((2, 2, 2048)))
    out = {}
    for dt, niter in ((torch.float32, 10), (torch.float64, 16)):
        dd, zz = d32.to(dt), z32.to(dt)
        rho = torch.full((2,), 0.7, dtype=dt)
        kp = torch.full((2,), 1536, dtype=torch.int32)
        o, t = tsec.secular_solve_batched(dd, zz * zz, rho, kp, niter=niter,
                                          chunk=256)
        zh, rows = tsec.secular_postpass_batched(R.to(dt), dd, zz, o, t, kp,
                                                 rho, chunk=256)
        assert bool(torch.isfinite(zh).all() and torch.isfinite(rows).all())
        out[dt] = [x.double().numpy() for x in
                   (tsec.secular_eigenvalues(dd, o, t), zh, rows)]
    assert (d32[:, 1:1536] == d32[:, :1535]).any(dim=1).all()
    ratio = np.finfo(np.float32).eps / EPS
    (l32, w32, r32), (l64, w64, r64) = out[torch.float32], out[torch.float64]
    np.testing.assert_allclose(l32, l64, atol=1e-13 * ratio, rtol=0)
    np.testing.assert_allclose(w32, w64, atol=1e-12 * ratio,
                               rtol=1e-10 * ratio)
    np.testing.assert_allclose(r32, r64, atol=1e-12 * ratio,
                               rtol=1e-10 * ratio)


def _coincident_pole_problem():
    """Eight poles, two of them one value (0.0), rho = 100: the root on
    the pair sits exactly on it and the next root lies 6.87 away, so the
    lower pole's product has a zero gap over a difference above 4."""
    d = np.array([[-40.0, -20.0, 0.0, 0.0, 30.0, 60.0, 90.0, 120.0]])
    z = np.random.default_rng(5).standard_normal((1, 8))
    return d, z / np.linalg.norm(z)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weights_where_poles_coincide_far_from_the_next_root(dtype):
    """A zero pole gap |d_j - d_i| with |lam_j - d_i| > 4 over it: floored
    at the smallest normal number in the working type, that factor was
    |lam_j - d_i| / tiny, past the type's largest number, and the weight
    came out inf.  The floors are now counted and cancel against the root's
    zero self term: the ratio-form weights (fused and resident plain
    versions) are finite and equal the log-space form's at
    tests/test_torch_kernels.py's tolerances, and the rows are finite."""
    dt = getattr(torch, dtype)
    d, z = _coincident_pole_problem()
    d, z = torch.tensor(d, dtype=dt), torch.tensor(z, dtype=dt)
    rho = torch.full((1,), 100.0, dtype=dt)
    kp = torch.full((1,), 8, dtype=torch.int32)
    o, t = tsec.secular_solve_batched(d, z * z, rho, kp, niter=16, chunk=8)
    lam = tsec.secular_eigenvalues(d, o, t)
    assert float(lam[0, 2]) == 0.0 and float(lam[0, 3]) > 4.0
    R = torch.eye(8, dtype=dt)[None]
    zh, rows = tsec.secular_postpass_batched(R, d, z, o, t, kp, rho, chunk=8)
    _, _, zr, rows_r = tsec.secular_merge_resident_batched(d, z, R, rho, kp)
    want = tsec.zhat_reconstruct_batched(d, z, o, t, kp, rho)
    scale = (np.finfo(np.float32).eps / EPS if dt == torch.float32 else 1.0)
    for w, r in ((zh, rows), (zr, rows_r)):
        assert bool(torch.isfinite(w).all() and torch.isfinite(r).all())
        np.testing.assert_allclose(w.numpy(), want.numpy(),
                                   atol=1e-12 * scale, rtol=1e-10 * scale)
