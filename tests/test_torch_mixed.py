"""The port's robustness layer on the CPU: ``certify_spectrum``,
``refine_clusters`` / ``precision="mixed"``, ``certify=True`` and the
degradation ladder, held to the JAX package on the same numpy inputs.

  * Certification is an integer predicate: on identical (d, e, lam) the
    certified masks and the count-verified brackets equal ``repro``'s
    exactly, and the scalar oracle (``kernels.ref.certify_ref``).
  * Refinement: the first round's miss mask equals ``repro``'s on the
    same input; results lie within 2 * refine_tol * eps_f64 *
    max(1, ||T||_inf) of ``repro``'s and within the 64-eps conformance bar
    of scipy's ``stebz``; untouched lanes come back bit-identical.
  * The ladder: the same FaultSpec schedule in both packages gives the
    same ``escalations`` tuple and eigenvalues within the bar.
"""

import functools

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bisect as jbis  # noqa: E402
from repro.core import clear_plan_cache as j_clear  # noqa: E402
from repro.core import eigvalsh_tridiagonal as j_eig  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro_torch.core import (FAMILIES, SOLVE_COUNTER,  # noqa: E402
                              CertificationError, SolveRequest,
                              certify_spectrum, clear_plan_cache,
                              eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br, execute_request,
                              make_family, plan_cache_stats,
                              refine_clusters)
from repro_torch.core import bisect as tbis  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.runtime import faults as tfaults  # noqa: E402

EPS = np.finfo(np.float64).eps
TOL = tbis.DEFAULT_REFINE_TOL
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles many one-off executables here (range,
    # certify and refine shapes, Pallas interpret); XLA:CPU keeps each
    # one's memory mappings for the life of the process, and the
    # vm.max_map_count budget is shared with the worker's later test
    # modules (tests/test_mixed.py releases its own the same way).
    yield
    j_clear()
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_slate():
    # Both packages' plan caches, fault schedules and degradation gauges
    # start and end every test empty.
    clear_plan_cache()
    j_clear()
    yield
    clear_plan_cache()
    j_clear()
    assert not tfaults.faults_enabled() and not jfaults.faults_enabled()


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
    return sla.eigh_tridiagonal(d, e, eigvals_only=True,
                                lapack_driver="stebz")


def _problem(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.normal(size=n), rng.normal(size=n - 1)


def _f32_estimates(d, e):
    """The mixed pipeline's first stage in isolation: the port's f32 tree
    solve of the f64 problem, upcast -- what refine_clusters receives."""
    lam = eigvalsh_tridiagonal_br(np.asarray(d, np.float32),
                                  np.asarray(e, np.float32), leaf=8,
                                  device=CPU).eigenvalues
    return lam.numpy().astype(np.float64)[None, :]


# ----------------------------------------------------------- certification


def test_certify_sweep_equals_repro_and_the_oracle():
    rng = np.random.default_rng(7)
    B, n = 3, 64
    d = rng.standard_normal((B, n))
    e = rng.standard_normal((B, n - 1))
    lam = np.stack([np.linalg.eigvalsh(np.diag(d[b]) + np.diag(e[b], 1)
                                       + np.diag(e[b], -1))
                    for b in range(B)])
    lam[:, ::5] += 1e-7                     # both outcomes appear
    nvalid = np.array([n, n, 50], np.int32)  # and vacuous padded lanes
    cj, loj, hij, tolj = jbis._certify_executor(
        jnp.asarray(d), jnp.asarray(e * e), jnp.asarray(lam),
        jnp.asarray(nvalid), jnp.asarray(TOL))
    ct, lot, hit, tolt = tbis._certify_executor(
        torch.tensor(d), torch.tensor(e * e), torch.tensor(lam),
        torch.tensor(nvalid), TOL)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(lot.numpy(), np.asarray(loj))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hij))
    np.testing.assert_array_equal(tolt.numpy(), np.asarray(tolj))
    full = tref.certify_ref(d, e, lam, tolt).numpy()
    np.testing.assert_array_equal(ct.numpy()[:2], full[:2])
    assert ct[2, 50:].all() and not ct.all() and ct.any()


def test_certified_brackets_enclose():
    rng = np.random.default_rng(11)
    n = 48
    d = rng.standard_normal((1, n))
    e = rng.standard_normal((1, n - 1))
    truth = np.linalg.eigvalsh(np.diag(d[0]) + np.diag(e[0], 1)
                               + np.diag(e[0], -1))
    lam = truth[None, :] + rng.uniform(-1e-8, 1e-8, (1, n))
    cert = certify_spectrum(d, e, lam, device=CPU)
    lo, hi = cert.lo.numpy()[0], cert.hi.numpy()[0]
    assert (lo <= truth).all() and (truth <= hi).all()


def test_certify_spectrum_single_and_flags():
    d, e = _problem(64)
    lam = eigvalsh_tridiagonal(d, e, device=CPU)
    cert = certify_spectrum(d, e, lam, device=CPU)
    assert cert.all_certified and cert.certified.shape == (64,)
    assert bool((cert.lo <= lam).all() and (lam <= cert.hi).all())
    bad = lam.clone()
    bad[10] += 0.1 * float(lam.max() - lam.min())
    cert = certify_spectrum(d, e, bad, device=CPU)
    assert not bool(cert.certified[10]) and not cert.all_certified
    want = jbis.certify_spectrum(d, e, bad.numpy())
    np.testing.assert_array_equal(cert.certified.numpy(),
                                  np.asarray(want.certified))


# -------------------------------------------------------------- refinement


@pytest.mark.parametrize("family", FAMILIES)
def test_refinement_against_repro_and_stebz(family):
    n = 128
    d, e = make_family(family, n, seed=n)
    lam0 = _f32_estimates(d, e)
    cj = jbis._certify_executor(
        jnp.asarray(d[None]), jnp.asarray((e * e)[None]), jnp.asarray(lam0),
        jnp.full((1,), n, jnp.int32), jnp.asarray(TOL))[0]
    ct = tbis._certify_executor(
        torch.tensor(d[None]), torch.tensor((e * e)[None]),
        torch.tensor(lam0), torch.full((1,), n, dtype=torch.int32), TOL)[0]
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    lam, info = refine_clusters(d[None], e[None], lam0, sort=False,
                                device=CPU)
    assert (info["polished_mask"] | ct.numpy()).all()
    jlam, jinfo = jbis.refine_clusters(d[None], e[None], lam0, sort=False)
    assert info["targets"] == jinfo["targets"] == n
    lam = lam.numpy()
    untouched = ~info["polished_mask"]
    np.testing.assert_array_equal(lam[untouched], lam0[untouched])
    np.testing.assert_allclose(lam, np.asarray(jlam), rtol=0,
                               atol=2 * TOL * EPS * max(1.0, _tinf(d, e)))
    np.testing.assert_allclose(np.sort(lam[0]), _stebz(family, n, n),
                               rtol=0, atol=_bar(d, e, 64))
    tol = TOL * EPS * max(1.0, np.abs(d).max() + 2.0 * np.abs(e).max())
    assert tref.certify_ref(d[None], e[None], lam, np.array([tol])).all()


def test_refinement_upcasts_and_sorts():
    n = 129
    d, e = make_family("wilkinson", n, seed=n)
    lam0 = _f32_estimates(d, e)
    lam, info = refine_clusters(d[None], e[None], lam0.astype(np.float32),
                                device=CPU)
    assert lam.dtype == torch.float64
    assert info["targets"] == n and 0 < info["polished"] <= n
    assert (np.diff(lam.numpy()[0]) >= 0).all()
    np.testing.assert_allclose(lam.numpy()[0], _stebz("wilkinson", n, n),
                               rtol=0, atol=_bar(d, e, 64))


# ------------------------------------------------------- precision="mixed"


@pytest.mark.parametrize("family,n", [("uniform", 128), ("clustered", 128),
                                      ("glued_wilkinson", 100)])
def test_mixed_solve_against_repro_and_stebz(family, n):
    d, e = make_family(family, n, seed=n)
    with SOLVE_COUNTER.measure(refinement=True) as window:
        got = eigvalsh_tridiagonal(d, e, leaf=8, precision="mixed",
                                   device=CPU)
    assert got.dtype == torch.float64 and got.shape == (n,)
    got = got.numpy()
    assert (np.diff(got) >= 0).all()
    want = np.asarray(j_eig(d, e, leaf=8, precision="mixed"))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * TOL * EPS * max(1.0, _tinf(d, e)))
    np.testing.assert_allclose(got, _stebz(family, n, n), rtol=0,
                               atol=_bar(d, e, 64))
    stats = window.refinement_stats
    assert stats["solves"] == 1 and stats["targets"] == n
    assert stats["max_rounds"] <= tbis.DEFAULT_REFINE_ROUNDS


def test_uncertified_mixed_lanes_escalate_to_native(monkeypatch):
    """The port certifies the last refine round (``repro`` returns it
    unchecked: ROADMAP Queue 3): with one round allowed, glued Wilkinson
    clusters stay uncertified, come back NaN from the plan, and the
    ladder re-solves their problem natively."""
    import functools
    n = 256
    d, e = make_family("glued_wilkinson", n, seed=1)
    lam0 = _f32_estimates(d, e)
    _, info = refine_clusters(d[None], e[None], lam0, rounds=1, device=CPU)
    assert info["uncertified"].any()
    monkeypatch.setattr(tplan._bis, "refine_clusters", functools.partial(
        tbis.refine_clusters, rounds=1))
    res = execute_request(SolveRequest(d=d, e=e, knobs={"precision": "mixed"},
                                       device=CPU))
    (esc,) = res.diagnostics["escalations"]
    assert (esc["from"], esc["to"]) == ("mixed", "native")
    assert esc["lanes"] > 0
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               _stebz("glued_wilkinson", n, 1), rtol=0,
                               atol=_bar(d, e, 64))


def test_uncertified_mixed_lanes_escalate_at_a_padded_size(monkeypatch):
    """At an n that pads (250 -> 256 at leaf=8) the sentinel lanes certify
    vacuously; a problem with an uncertified lane must still come back
    all NaN from the plan, or the sort would put its NaNs after the
    sentinels, the [:n] cut would keep the sentinels as eigenvalues and
    the finalizer would see nothing to escalate."""
    import functools
    n = 250
    d, e = make_family("glued_wilkinson", n, seed=1)
    lam0 = _f32_estimates(d, e)
    _, info = refine_clusters(d[None], e[None], lam0, rounds=1, device=CPU)
    assert info["uncertified"].any()
    monkeypatch.setattr(tplan._bis, "refine_clusters", functools.partial(
        tbis.refine_clusters, rounds=1))
    direct = eigvalsh_tridiagonal_br(d, e, leaf=8, precision="mixed",
                                     device=CPU).eigenvalues
    assert direct.shape == (n,) and torch.isnan(direct).all()
    res = execute_request(SolveRequest(d=d, e=e, knobs={"precision": "mixed",
                                                        "leaf": 8},
                                       device=CPU))
    (esc,) = res.diagnostics["escalations"]
    assert (esc["from"], esc["to"]) == ("mixed", "native")
    lam = res.eigenvalues.numpy()
    assert lam.shape == (n,) and np.isfinite(lam).all()
    assert lam.max() <= _tinf(d, e)
    np.testing.assert_allclose(lam, _stebz("glued_wilkinson", n, 1), rtol=0,
                               atol=_bar(d, e, 64))


def test_mixed_padded_batched_with_boundary_rows():
    rng = np.random.default_rng(3)
    B, n = 4, 100                      # pads to 128 at leaf=8
    d = rng.standard_normal((B, n))
    e = rng.standard_normal((B, n - 1))
    res = eigvalsh_tridiagonal_batch(d, e, leaf=8, precision="mixed",
                                     return_boundary=True, device=CPU)
    lam = res.eigenvalues.numpy()
    assert lam.shape == (B, n) and lam.dtype == np.float64
    assert res.blo.dtype == torch.float64 and res.bhi.dtype == torch.float64
    assert (np.diff(lam, axis=1) >= 0.0).all()
    tol = TOL * EPS * np.maximum(
        1.0, np.abs(d).max(axis=1) + 2.0 * np.abs(e).max(axis=1))
    assert tref.certify_ref(d, e, lam, 2.0 * tol).all()
    ref = eigvalsh_tridiagonal_batch(d, e, leaf=8, return_boundary=True,
                                     device=CPU)
    np.testing.assert_allclose(np.abs(res.bhi.numpy()),
                               np.abs(ref.bhi.numpy()), rtol=0, atol=1e-4)


def test_mixed_routes_and_validation():
    native = tplan.resolve_solve_route(257, leaf=8, device=CPU)
    mixed = tplan.resolve_solve_route(257, leaf=8, precision="mixed",
                                      device=CPU)
    assert mixed == tplan.resolve_solve_route(257, leaf=8, device=CPU,
                                              precision="mixed")
    assert mixed != native and native.refine_tol == 0.0
    assert mixed.refine_tol == TOL and mixed.dtype == "float64"
    assert mixed.niter == 10          # the f32 tree's secular budget
    with pytest.raises(ValueError, match="refine_tol only applies"):
        tplan.resolve_solve_route(64, refine_tol=16.0, device=CPU)
    with pytest.raises(ValueError, match="refine_tol must be positive"):
        tplan.resolve_solve_route(64, precision="mixed", refine_tol=0.0,
                                  device=CPU)
    with pytest.raises(ValueError, match="float64 or None"):
        tplan.resolve_solve_route(64, precision="mixed",
                                  dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="precision must be"):
        tplan.resolve_solve_route(64, precision="half", device=CPU)


def test_native_f64_bit_identical_around_mixed_traffic():
    d, e = make_family("clustered", 128, seed=1)
    before = eigvalsh_tridiagonal(d, e, leaf=8, device=CPU)
    eigvalsh_tridiagonal(d, e, leaf=8, precision="mixed", device=CPU)
    assert torch.equal(eigvalsh_tridiagonal(d, e, leaf=8, device=CPU),
                       before)


# ------------------------------------------------------------ certify=True


@pytest.mark.parametrize("method", ["br", "bisect"])
def test_certify_knob_against_repro(method):
    d, e = _problem(48)
    res = execute_request(SolveRequest(d=d, e=e, method=method,
                                       certify=True, device=CPU))
    assert res.diagnostics["certified"] == 48
    assert res.diagnostics["lanes"] == 48
    plain = eigvalsh_tridiagonal(d, e, method=method, device=CPU)
    assert torch.equal(res.eigenvalues, plain)
    want = jreq.execute_request(jreq.SolveRequest(d=d, e=e, method=method,
                                                  certify=True))
    assert want.diagnostics == res.diagnostics
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=0,
                               atol=_bar(d, e, 64))


def test_certify_does_not_split_the_tree():
    d, e = _problem(48)
    eigvalsh_tridiagonal(d, e, device=CPU)
    builds = plan_cache_stats()["executor_traces"]
    eigvalsh_tridiagonal(d, e, certify=True, device=CPU)
    assert plan_cache_stats()["executor_traces"] == builds
    assert plan_cache_stats()["refine_executor_traces"] >= 1


def test_certified_mixed_and_certified_range():
    d, e = _problem(96)
    lam = eigvalsh_tridiagonal(d, e, leaf=8, precision="mixed",
                               certify=True, device=CPU).numpy()
    np.testing.assert_allclose(lam, eigvalsh_tridiagonal(d, e, device=CPU),
                               rtol=0, atol=_bar(d, e, 64))
    res = execute_request(SolveRequest(d=d, e=e, kind="range", il=0, iu=7,
                                       certify=True, device=CPU))
    assert res.diagnostics == {"certified": 8, "lanes": 8}


# ------------------------------------------------------------------ ladder


def _both(specs, **req):
    """Run one request under one fault schedule in both packages."""
    tfaults.configure_faults([tfaults.FaultSpec(**s) for s in specs])
    try:
        got = execute_request(SolveRequest(device=CPU, **req))
    finally:
        tfaults.reset_faults()
    jfaults.configure_faults([jfaults.FaultSpec(**s) for s in specs])
    try:
        want = jreq.execute_request(jreq.SolveRequest(**req))
    finally:
        jfaults.reset_faults()
    return got, want


POISON = dict(site="plan.output", kind="nan", times=(0,), lane=0, width=1)


@pytest.mark.parametrize("certify", [False, True])
def test_poisoned_output_escalates_like_repro(certify):
    d, e = _problem(48)
    ref = eigvalsh_tridiagonal(d, e, device=CPU).numpy()
    gstart = len(SOLVE_COUNTER.degradation_events())
    got, want = _both([POISON], d=d, e=e, certify=certify)
    assert got.diagnostics["escalations"] == want.diagnostics["escalations"]
    if not certify:
        assert got.diagnostics["escalations"] == (
            {"from": "native", "to": "bisect", "lanes": 48},)
        assert ("native", "bisect", 48) in \
            SOLVE_COUNTER.degradation_events(gstart)
    assert plan_cache_stats()["degradations"] >= 1
    np.testing.assert_allclose(got.eigenvalues.numpy(), ref, rtol=0,
                               atol=_bar(d, e, 64))
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=0,
                               atol=_bar(d, e, 64))


def test_mixed_poison_then_persistent_launch_fault_like_repro():
    """Poisoned output rows, then a launch fault on every later launch:
    the mixed stage's native re-solve fails, so the lanes go to per-lane
    bisection -- in both packages, with the same escalations."""
    d, e = _problem(96)
    specs = [POISON, dict(site="plan.launch", kind="error",
                          times=tuple(range(1, 64)))]
    got, want = _both(specs, d=d, e=e,
                      knobs={"precision": "mixed", "leaf": 8})
    esc = got.diagnostics["escalations"]
    assert esc == want.diagnostics["escalations"]
    assert esc == ({"from": "mixed", "to": "bisect", "lanes": 96},)
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=0,
                               atol=_bar(d, e, 64))


def test_mixed_poison_escalates_to_native_like_repro():
    d, e = _problem(96)
    got, want = _both([POISON], d=d, e=e,
                      knobs={"precision": "mixed", "leaf": 8})
    assert got.diagnostics["escalations"] == want.diagnostics["escalations"]
    assert got.diagnostics["escalations"][0]["from"] == "mixed"
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=0,
                               atol=_bar(d, e, 64))


def test_poison_harms_only_its_lane_and_launch_faults_surface():
    probs = [_problem(40, seed=17 * i) for i in range(3)]
    D = np.stack([p[0] for p in probs])
    E = np.stack([p[1] for p in probs])
    ref = eigvalsh_tridiagonal(D, E, device=CPU)
    got, want = _both([dict(POISON, lane=1)], d=D, e=E, kind="batch")
    assert torch.equal(got.eigenvalues[0], ref[0])
    assert torch.equal(got.eigenvalues[2], ref[2])
    np.testing.assert_allclose(got.eigenvalues[1].numpy(),
                               ref[1].numpy(), rtol=0,
                               atol=_bar(D[1], E[1], 64))
    assert got.diagnostics["escalations"] == want.diagnostics["escalations"]
    tfaults.configure_faults([tfaults.FaultSpec(
        site="plan.launch", kind="error", times=(0,), error="transient")])
    with pytest.raises(tfaults.InjectedTransientError):
        eigvalsh_tridiagonal(D, E, device=CPU)
    tfaults.reset_faults()
    # A disarmed harness is bit-invisible.
    assert torch.equal(eigvalsh_tridiagonal(D, E, device=CPU), ref)


def test_owed_boundary_rows_that_cannot_be_recovered_raise():
    d, e = _problem(40)
    tfaults.configure_faults([
        tfaults.FaultSpec(**POISON),
        tfaults.FaultSpec(site="plan.launch", kind="error",
                          times=tuple(range(1, 8)))])
    try:
        with pytest.raises(CertificationError, match="boundary rows"):
            execute_request(SolveRequest(d=d, e=e, return_boundary=True,
                                         device=CPU))
    finally:
        tfaults.reset_faults()
