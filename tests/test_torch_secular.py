"""Parity of the port's plain secular versions (repro_torch.core.secular)
with the JAX package: its XLA path (repro.core.secular) and its Pallas
kernels run in interpret mode.

Same numpy inputs to both packages; same tolerances as
tests/test_kernels.py (eigenvalues compared as d[origin] + tau, never
origin itself, since either gap endpoint is a valid origin).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import secular as jsec  # noqa: E402
from repro.kernels.fused_update import secular_postpass_pallas  # noqa: E402
from repro.kernels.resident_merge import resident_merge_pallas  # noqa: E402
from repro.kernels.secular_roots import secular_solve_pallas  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


SHAPES = [(32, 17), (64, 64), (130, 101)]


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles one executable per shape here; XLA:CPU
    # keeps each one's memory mappings for the life of the process, and
    # the vm.max_map_count budget is shared with the worker's later test
    # modules (see tests/test_torch_bisect.py).
    yield
    jax.clear_caches()


def _problem(K, kprime, seed=0):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal(K))
    d[kprime:] += 10.0                     # deflated values parked high
    z = rng.standard_normal(K)
    z[kprime:] = 0.0
    z /= np.linalg.norm(z)
    return d, z, 0.7


def _lam(d, origin, tau):
    return np.asarray(d)[np.asarray(origin)] + np.asarray(tau)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_solve_matches_jax(K, kprime):
    d, z, rho = _problem(K, kprime, seed=1)
    o_x, t_x = jsec.secular_solve(jnp.asarray(d), jnp.asarray(z * z), rho,
                                  kprime, niter=16)
    o_p, t_p = secular_solve_pallas(jnp.asarray(d), jnp.asarray(z * z),
                                    jnp.asarray(rho), jnp.asarray(kprime),
                                    niter=16, interpret=True)
    o_t, t_t = tsec.secular_solve(_t(d), _t(z * z), rho, kprime, niter=16,
                                  chunk=48)
    lam_t = _lam(d, o_t.numpy(), t_t.numpy())
    np.testing.assert_allclose(lam_t, _lam(d, o_x, t_x), atol=1e-13, rtol=0)
    np.testing.assert_allclose(lam_t, _lam(d, o_p, t_p), atol=1e-13, rtol=0)
    o_r, t_r = tref.secular_roots_ref(_t(d), _t(z * z), rho, kprime)
    np.testing.assert_allclose(np.sort(lam_t[:kprime]),
                               np.sort(_lam(d, o_r, t_r)[:kprime]),
                               atol=1e-10 * 10, rtol=1e-10)


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_solve_dense_chunk_and_batch_invariance(K, kprime):
    """Chunking, dense mode and the batch axis are scheduling knobs: the
    per-root arithmetic is elementwise, so results are bit-identical."""
    d, z, rho = _problem(K, kprime, seed=2)
    base = tsec.secular_solve(_t(d), _t(z * z), rho, kprime, niter=16,
                              chunk=K)
    for kw in (dict(chunk=7), dict(dense=True)):
        o, t = tsec.secular_solve(_t(d), _t(z * z), rho, kprime, niter=16,
                                  **kw)
        assert torch.equal(o, base[0]) and torch.equal(t, base[1])
    d2, z2, _ = _problem(K, max(1, kprime // 2), seed=3)
    D = _t(np.stack([d2, d]))
    Z2 = _t(np.stack([z2 * z2, z * z]))
    ob, tb = tsec.secular_solve_batched(
        D, Z2, torch.tensor([1.3, rho], dtype=torch.float64),
        torch.tensor([max(1, kprime // 2), kprime]), niter=16, chunk=K)
    assert torch.equal(ob[1], base[0]) and torch.equal(tb[1], base[1])


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_postpass_matches_jax(K, kprime):
    r = 3
    d, z, rho = _problem(K, kprime, seed=6)
    origin, tau = jsec.secular_solve(jnp.asarray(d), jnp.asarray(z * z), rho,
                                     kprime, niter=16)
    R = np.random.default_rng(6).standard_normal((r, K))
    zh_x, rows_x = jsec.secular_postpass(jnp.asarray(R), jnp.asarray(d),
                                         jnp.asarray(z), origin, tau,
                                         kprime, rho)
    args = (_t(R), _t(d), _t(z), _t(origin), _t(tau), kprime, rho)
    zh_t, rows_t = tsec.secular_postpass(*args, chunk=48)
    np.testing.assert_allclose(zh_t.numpy(), np.asarray(zh_x),
                               atol=1e-12, rtol=1e-10)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_x),
                               atol=1e-12, rtol=1e-10)
    zh_d, rows_d = tsec.secular_postpass(*args, dense=True)
    np.testing.assert_allclose(rows_d.numpy(), rows_t.numpy(), atol=1e-13,
                               rtol=0)
    zh_o, rows_o = tref.secular_postpass_ref(_t(R), _t(d), _t(z), _t(origin),
                                             _t(tau), kprime, rho)
    np.testing.assert_allclose(zh_t.numpy(), zh_o.numpy(), atol=1e-10,
                               rtol=1e-8)
    np.testing.assert_allclose(rows_t.numpy(), rows_o.numpy(), atol=1e-10,
                               rtol=1e-8)


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_postpass_matches_pallas_interpret(K, kprime):
    d, z, rho = _problem(K, kprime, seed=8)
    origin, tau = jsec.secular_solve(jnp.asarray(d), jnp.asarray(z * z), rho,
                                     kprime, niter=16)
    R = np.random.default_rng(8).standard_normal((2, K))
    zh_p, rows_p = secular_postpass_pallas(
        jnp.asarray(R), jnp.asarray(d), jnp.asarray(z), origin, tau,
        jnp.asarray(kprime), jnp.asarray(rho), interpret=True)
    zh_t, rows_t = tsec.secular_postpass(_t(R), _t(d), _t(z), _t(origin),
                                         _t(tau), kprime, rho)
    np.testing.assert_allclose(zh_t.numpy(), np.asarray(zh_p),
                               atol=1e-12, rtol=1e-10)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_p),
                               atol=1e-12, rtol=1e-10)


@pytest.mark.parametrize("K,kprime", SHAPES)
def test_plain_resident_matches_pallas_interpret(K, kprime):
    """The JAX package's resident composition is its dense solve + dense
    post-pass (pinned in tests/test_kernels.py), both compared above; here
    the port's resident merge meets the Pallas kernel itself."""
    rng = np.random.default_rng(10)
    d, z, rho = _problem(K, kprime, seed=10)
    R = rng.standard_normal((3, K))
    o_p, t_p, zh_p, rows_p = resident_merge_pallas(
        jnp.asarray(d), jnp.asarray(z), jnp.asarray(R), jnp.asarray(rho),
        jnp.asarray(kprime), interpret=True)
    o_t, t_t, zh_t, rows_t = tops.secular_merge_resident(
        _t(d), _t(z), _t(R), rho, kprime)
    np.testing.assert_allclose(_lam(d, o_t.numpy(), t_t.numpy()),
                               _lam(d, o_p, t_p), atol=1e-13, rtol=0)
    np.testing.assert_allclose(zh_t.numpy(), np.asarray(zh_p), atol=1e-12,
                               rtol=1e-10)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_p),
                               atol=1e-12, rtol=1e-10)


def test_resident_is_dense_solve_plus_dense_postpass():
    """The plain resident merge is exactly the dense two-step pipeline."""
    d, z, rho = _problem(64, 50, seed=11)
    R = _t(np.random.default_rng(11).standard_normal((2, 64)))
    o1, t1, zh1, rows1 = tsec.secular_merge_resident(_t(d), _t(z), R, rho, 50)
    o2, t2 = tsec.secular_solve(_t(d), _t(z * z), rho, 50, dense=True)
    zh2, rows2 = tsec.secular_postpass(R, _t(d), _t(z), o2, t2, 50, rho,
                                       dense=True)
    for a, b in ((o1, o2), (t1, t2), (zh1, zh2), (rows1, rows2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,niter", [(torch.float64, 16),
                                         (torch.float32, 10)])
def test_resolve_niter_per_dtype(dtype, niter):
    assert tops.resolve_niter(None, dtype) == niter
    assert tops.resolve_niter(7, dtype) == 7


def test_f32_solve_matches_jax_at_f32_accuracy():
    d, z, rho = _problem(130, 101, seed=12)
    d32, z32 = d.astype(np.float32), z.astype(np.float32)
    o_x, t_x = jsec.secular_solve(jnp.asarray(d32), jnp.asarray(z32 * z32),
                                  np.float32(rho), 101, niter=10)
    o_t, t_t = tsec.secular_solve(_t(d32), _t(z32 * z32), rho, 101,
                                  niter=10)
    assert t_t.dtype == torch.float32 and o_t.dtype == torch.int32
    eps_ratio = np.finfo(np.float32).eps / np.finfo(np.float64).eps
    np.testing.assert_allclose(_lam(d32, o_t.numpy(), t_t.numpy()),
                               _lam(d32, o_x, t_x), atol=1e-13 * eps_ratio,
                               rtol=0)


def test_plain_batched_versions_vs_batched_oracles():
    """The batched plain versions (problems on the leading axis) against
    the literal loops of dense oracles in repro_torch.kernels.ref."""
    B, K = 3, 48
    probs = [_problem(K, kp, seed=20 + b) for b, kp in enumerate((8, 48, 31))]
    d = _t(np.stack([p[0] for p in probs]))
    z = _t(np.stack([p[1] for p in probs]))
    kprime = torch.tensor([8, 48, 31], dtype=torch.int32)
    rho = torch.tensor([0.7, 1.3, 0.2], dtype=torch.float64)
    R = _t(np.random.default_rng(12).standard_normal((B, 2, K)))
    o, t, zh, rows = tsec.secular_merge_resident_batched(d, z, R, rho, kprime)
    o_r, t_r, zh_r, rows_r = tref.resident_merge_batch_ref(d, z, R, rho,
                                                           kprime)
    for b, kp in enumerate((8, 48, 31)):
        np.testing.assert_allclose(
            np.sort(tsec.secular_eigenvalues(d[b], o[b], t[b])[:kp]),
            np.sort(tsec.secular_eigenvalues(d[b], o_r[b], t_r[b])[:kp]),
            atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(rows.numpy(), rows_r.numpy(), atol=1e-8,
                               rtol=1e-6)
    o_s, t_s = tref.secular_roots_batch_ref(d, z * z, rho, kprime)
    zh_p, rows_p = tsec.secular_postpass_batched(R, d, z, o_s, t_s, kprime,
                                                 rho)
    zh_o, rows_o = tref.secular_postpass_batch_ref(R, d, z, o_s, t_s, kprime,
                                                   rho)
    np.testing.assert_allclose(rows_p.numpy(), rows_o.numpy(), atol=1e-10,
                               rtol=1e-8)
