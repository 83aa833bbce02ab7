"""The port's spectral estimates (``repro_torch.spectral``) on the CPU,
held to the JAX package (``repro.spectral``) on the same inputs.

JAX's Rademacher bits cannot be drawn by torch, so the tests take the
JAX package's probes (``repro.spectral.slq._rademacher_like``) across as
numpy and hold the code after the draw:

  * Lanczos (``lanczos_tridiag``, ``lanczos_tridiag_batch``) on a 64 x 64
    dense operator and a diagonal operator on a nested dict of
    parameters, m = 16: alpha and beta within rtol 1e-4 of the JAX
    package's (float32 sums in another order);
  * ``make_hvp`` and ``make_gnvp`` of a small tanh MLP, float32, within
    rtol 1e-4 (atol 1e-6 of the largest entry);
  * the SLQ estimate of the JAX package's own Krylov tridiagonals (its
    ``slq_spectrum`` run): nodes within 64 eps * max(1, ||T||_inf), the
    square roots of the weights (|blo|) within 1e-10, the boundary-row
    bar of tests/test_torch_solver.py; ``edges_from_tridiag`` within
    64 eps * max(1, ||T||_inf);
  * served ``kind="slq"``, edges and sharpness equal to the direct
    results bit for bit, and one batched solve per probe set;
  * a diagonal operator with a set spectrum: SLQ's extremes inside it and
    within 1e-4 of its ends, its trace estimate within 1e-5 relative
    (exact for a diagonal operator up to float32 rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.spectral import hvp as jhvp  # noqa: E402
from repro.spectral import lanczos as jlz  # noqa: E402
from repro.spectral import slq as jslq  # noqa: E402
from repro_torch.core import SOLVE_COUNTER  # noqa: E402
from repro_torch.serve import EigensolverClient  # noqa: E402
from repro_torch.spectral import (edges_from_tridiag,  # noqa: E402
                                  lanczos_tridiag, lanczos_tridiag_batch,
                                  make_gnvp, make_hvp, sharpness,
                                  slq_spectrum)
from repro_torch.spectral import slq as tslq  # noqa: E402
from repro_torch.tree import (tree_from_numpy, tree_leaves,  # noqa: E402
                              tree_map)

CPU = "cpu"
EPS = np.finfo(np.float64).eps
STEPS = 16


from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _operator(name):
    """(params_like as numpy, JAX matvec, torch matvec) of a test operator."""
    rng = np.random.default_rng(11)
    if name == "dense":
        A = rng.standard_normal((64, 64)).astype(np.float32)
        A = (A + A.T) / 2
        Aj, At = jnp.asarray(A), torch.from_numpy(A)
        like = {"x": np.zeros(64, np.float32)}
        return (like, lambda v: {"x": Aj @ v["x"]},
                lambda v: {"x": At @ v["x"]})
    like = {"a": np.zeros((8, 4), np.float32),
            "b": {"c": np.zeros(10, np.float32),
                  "d": np.zeros((3, 2), np.float32)}}
    diag = jax.tree.map(
        lambda x: rng.uniform(-2, 3, x.shape).astype(np.float32), like)
    dj = jax.tree.map(jnp.asarray, diag)
    dt = tree_from_numpy(diag, CPU)
    return (like, lambda v: jax.tree.map(lambda d, x: d * x, dj, v),
            lambda v: tree_map(lambda d, x: d * x, dt, v))


def _probes(like, num, seed=0):
    """The JAX package's Rademacher probes of ``slq_spectrum`` (fold_in of
    the key by probe index), stacked, as numpy."""
    key = jax.random.PRNGKey(seed)
    like_j = jax.tree.map(jnp.asarray, like)
    probes = [jslq._rademacher_like(jax.random.fold_in(key, k), like_j)
              for k in range(num)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *probes)
    return jax.tree.map(np.asarray, stacked)


@functools.lru_cache(maxsize=None)
def _jax_tridiag(name, num, seed):
    """The JAX package's Krylov tridiagonals of an operator on its own
    probes, as numpy float32 (alpha (num, m), beta (num, m-1))."""
    like, jmv, _ = _operator(name)
    aj, bj = jlz.lanczos_tridiag_batch(
        jmv, jax.tree.map(jnp.asarray, _probes(like, num, seed)), STEPS)
    return np.asarray(aj), np.asarray(bj)


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _tinf(d, e):
    row = np.abs(np.asarray(d, np.float64)).copy()
    row[:-1] += np.abs(e)
    row[1:] += np.abs(e)
    return float(row.max())


# ---------------------------------------------------------------- Lanczos


@pytest.mark.parametrize("name", ["dense", "dict-diag"])
def test_lanczos_matches_repro_on_its_probes(name):
    like, jmv, tmv = _operator(name)
    probes = _probes(like, 3, seed=2)
    aj, bj = _jax_tridiag(name, 3, 2)
    at, bt = lanczos_tridiag_batch(tmv, tree_from_numpy(probes, CPU), STEPS)
    assert at.dtype == bt.dtype == torch.float32
    assert tuple(at.shape) == (3, STEPS) and tuple(bt.shape) == (3, STEPS - 1)
    _close(at.numpy(), aj, 1e-4)
    _close(bt.numpy(), bj, 1e-4)
    if name == "dense":
        # One probe through the unbatched loop.
        one = jax.tree.map(lambda x: x[0], probes)
        a1j, b1j = jlz.lanczos_tridiag(jmv, jax.tree.map(jnp.asarray, one),
                                       STEPS)
        a1t, b1t = lanczos_tridiag(tmv, tree_from_numpy(one, CPU), STEPS)
        _close(a1t.numpy(), a1j, 1e-4)
        _close(b1t.numpy(), b1j, 1e-4)
    # The batched run is the loop's, probe by probe.
    probes_t = tree_from_numpy(probes, CPU)
    for p in range(3):
        a, b = lanczos_tridiag(tmv, tree_map(lambda x: x[p], probes_t),
                               STEPS)
        _close(at[p].numpy(), a.numpy(), 1e-5)
        _close(bt[p].numpy(), b.numpy(), 1e-5)


# ------------------------------------------------------------ HVP and GNVP


def _mlp():
    rng = np.random.default_rng(3)
    params = {"w1": rng.standard_normal((6, 8)).astype(np.float32) / 2,
              "b1": rng.standard_normal(8).astype(np.float32) / 4,
              "w2": rng.standard_normal((8, 3)).astype(np.float32) / 2}
    X = rng.standard_normal((5, 6)).astype(np.float32)
    Y = rng.standard_normal((5, 3)).astype(np.float32)
    # The tangent keeps the parameters' key order: torch.func takes a
    # dict's order as part of its structure.
    v = {k: rng.standard_normal(x.shape).astype(np.float32)
         for k, x in params.items()}

    def logits_j(p):
        return jnp.tanh(X @ p["w1"] + p["b1"]) @ p["w2"]

    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)

    def logits_t(p):
        return torch.tanh(Xt @ p["w1"] + p["b1"]) @ p["w2"]

    return params, v, (logits_j, lambda lg: jnp.mean((lg - Y) ** 2)), \
        (logits_t, lambda lg: torch.mean((lg - Yt) ** 2))


def test_hvp_and_gnvp_match_repro():
    params, v, (lj, hj), (lt, ht) = _mlp()
    pj = jax.tree.map(jnp.asarray, params)
    vj = jax.tree.map(jnp.asarray, v)
    pt, vt = tree_from_numpy(params, CPU), tree_from_numpy(v, CPU)
    got = make_hvp(lambda p: ht(lt(p)), pt)(vt)
    want = jhvp.make_hvp(lambda p: hj(lj(p)), pj)(vj)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        _close(g.detach().numpy(), w, 1e-4)
    got = make_gnvp(lt, ht, pt)(vt)
    want = jhvp.make_gnvp(lj, hj, pj)(vj)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        _close(g.detach().numpy(), w, 1e-4)
    # Gauss-Newton is positive semi-definite on its own vector.
    gv = sum(float(torch.sum(a * b)) for a, b in
             zip(tree_leaves(got), tree_leaves(vt)))
    assert gv >= 0.0
    # Batched over probes (the Lanczos form) equals one by one.
    hvp = make_hvp(lambda p: ht(lt(p)), pt)
    stacked = tree_map(lambda x: torch.stack([x, 2 * x]), vt)
    batched = torch.func.vmap(hvp)(stacked)
    for b, one in zip(tree_leaves(batched), tree_leaves(hvp(vt))):
        _close(b[1].detach().numpy(), 2 * one.detach().numpy(), 1e-5)


# ---------------------------------------------------------------- SLQ


def test_estimate_matches_repro_slq_on_its_tridiagonals():
    like, jmv, _ = _operator("dense")
    alpha, beta = _jax_tridiag("dense", 3, 2)
    want = jslq.slq_spectrum(jmv, jax.tree.map(jnp.asarray, like),
                             jax.random.PRNGKey(2), num_probes=3,
                             num_steps=STEPS, leaf=8)
    got = tslq._estimate(alpha, beta, 64, leaf=8, device=CPU)
    assert got.nodes.shape == got.weights.shape == (3, STEPS)
    for p in range(3):
        bar = 64 * EPS * max(1.0, _tinf(alpha[p].astype(np.float64),
                                        beta[p].astype(np.float64)))
        assert np.abs(got.nodes[p] - want.nodes[p]).max() <= bar
    np.testing.assert_allclose(np.sqrt(got.weights), np.sqrt(want.weights),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.weights.sum(axis=1), 1.0, rtol=0,
                               atol=1e-12)
    assert got.trace_est == pytest.approx(want.trace_est, rel=1e-9,
                                          abs=1e-9)
    assert got.lam_max == pytest.approx(want.lam_max, rel=1e-12)
    assert got.lam_min == pytest.approx(want.lam_min, rel=1e-12)
    grid = np.linspace(got.lam_min, got.lam_max, 33)
    np.testing.assert_allclose(got.density(grid), want.density(grid),
                               rtol=1e-6, atol=1e-12)


def test_edges_from_tridiag_match_repro():
    alpha, beta = _jax_tridiag("dict-diag", 3, 2)
    lo_j, hi_j = jslq.edges_from_tridiag(alpha, beta, k=2)
    lo_t, hi_t = edges_from_tridiag(alpha, beta, k=2, device=CPU)
    assert lo_t.shape == hi_t.shape == (3, 2)
    for p in range(3):
        bar = 64 * EPS * max(1.0, _tinf(alpha[p].astype(np.float64),
                                        beta[p].astype(np.float64)))
        assert np.abs(lo_t[p] - np.asarray(lo_j)[p]).max() <= bar
        assert np.abs(hi_t[p] - np.asarray(hi_j)[p]).max() <= bar
    # Tensors solve on their own device without being told.
    lo2, hi2 = edges_from_tridiag(torch.from_numpy(alpha.copy()),
                                  torch.from_numpy(beta.copy()), k=2)
    assert np.array_equal(lo2, lo_t) and np.array_equal(hi2, hi_t)


def test_served_slq_edges_and_sharpness_equal_direct_bitwise():
    like, _, tmv = _operator("dense")
    params = tree_from_numpy(like, CPU)

    def gen():
        return torch.Generator().manual_seed(7)

    start = SOLVE_COUNTER.count
    direct = slq_spectrum(tmv, params, gen(), num_probes=3,
                          num_steps=STEPS, leaf=8)
    assert SOLVE_COUNTER.count - start == 1    # one solve, every probe
    alpha, beta = lanczos_tridiag_batch(tmv, tslq._probes(gen(), params, 3),
                                        STEPS)
    with EigensolverClient(max_wait_us=1000) as client:
        served = slq_spectrum(tmv, params, gen(), num_probes=3,
                              num_steps=STEPS, leaf=8, client=client)
        edges_s = edges_from_tridiag(alpha, beta, k=3, client=client)
        sharp_s = sharpness(tmv, params, gen(), client=client)
        slq_kinds = client.metrics()["buckets"]
    assert np.array_equal(direct.nodes, served.nodes)
    assert np.array_equal(direct.weights, served.weights)
    assert direct.trace_est == served.trace_est
    assert direct.lam_max == served.lam_max
    edges_d = edges_from_tridiag(alpha, beta, k=3)
    assert all(np.array_equal(a, b) for a, b in zip(edges_s, edges_d))
    assert sharp_s == sharpness(tmv, params, gen())
    assert "solve/N16/float64+rows" in slq_kinds
    # The probes' Lanczos is the one slq_spectrum ran.
    est = tslq._estimate(alpha, beta, 64, leaf=8)
    assert np.array_equal(est.nodes, direct.nodes)


def test_known_spectrum_extremes_and_trace():
    """A diagonal operator with a set spectrum: a bulk in [0.1, 1] and one
    isolated eigenvalue at each end (-0.5 and 2.0)."""
    dim = 4000
    rng = np.random.default_rng(8)
    spec = rng.uniform(0.1, 1.0, dim).astype(np.float32)
    spec[[17, 2900]] = (-0.5, 2.0)
    diag = {"u": torch.from_numpy(spec[:1000].reshape(10, 100)),
            "v": torch.from_numpy(spec[1000:])}
    like = tree_map(torch.zeros_like, diag)
    est = slq_spectrum(lambda v: tree_map(lambda d, x: d * x, diag, v), like,
                       torch.Generator().manual_seed(1), num_probes=2,
                       num_steps=32, leaf=8)
    inside = 64 * np.finfo(np.float32).eps * 2.0
    assert -0.5 - inside <= est.lam_min and est.lam_max <= 2.0 + inside
    assert abs(est.lam_max - 2.0) <= 1e-4 and abs(est.lam_min + 0.5) <= 1e-4
    trace = float(np.sum(spec.astype(np.float64)))
    assert est.trace_est == pytest.approx(trace, rel=1e-5)
