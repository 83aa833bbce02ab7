"""Parity of the port's merge level (repro_torch.core.merge) with the JAX
package's (repro.core.merge) on the same numpy level inputs.

Lanes come from real leaf solves (numpy eigh of the coupled-subtracted
leaf blocks) of ``uniform`` and ``glued_wilkinson`` problems; both
packages merge them at ``deflate_budget`` 64 (the parallel deflation head
with its host-decided chain length) and 0 (the sequential chain), through
the streamed and the resident paths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import merge as jmerge  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core.tridiag import make_family  # noqa: E402


from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles one executable per shape here; XLA:CPU
    # keeps each one's memory mappings for the life of the process, and
    # the vm.max_map_count budget is shared with the worker's later test
    # modules (see tests/test_torch_bisect.py).
    yield
    jax.clear_caches()


def _level_inputs(family, n, leaf, seed):
    """Level-0 merge lanes of one problem: (lam_pairs, z_inner, R, rho,
    sgn) as numpy arrays, shapes (W, 2, M), (W, 2, M), (W, 2, 2M), (W,),
    (W,)."""
    d, e = make_family(family, n, seed=seed)
    nb = n // leaf
    k = leaf * np.arange(1, nb)
    d = d.copy()
    d[k - 1] -= np.abs(e[k - 1])
    d[k] -= np.abs(e[k - 1])
    lams, rows = [], []
    for b in range(nb):
        s = slice(b * leaf, (b + 1) * leaf)
        eb = np.append(e, 0.0)[s][:-1]
        T = np.diag(d[s]) + np.diag(eb, 1) + np.diag(eb, -1)
        w, Q = np.linalg.eigh(T)
        lams.append(w)
        rows.append(np.stack([Q[0], Q[-1]]))
    lam = np.stack(lams).reshape(nb // 2, 2, leaf)
    rows = np.stack(rows).reshape(nb // 2, 2, 2, leaf)
    z_inner = np.stack([rows[:, 0, 1], rows[:, 1, 0]], axis=1)
    zeros = np.zeros((nb // 2, leaf))
    R = np.stack([np.concatenate([rows[:, 0, 0], zeros], -1),
                  np.concatenate([zeros, rows[:, 1, 1]], -1)], axis=1)
    beta = e[(2 * np.arange(nb // 2) + 1) * leaf - 1]
    return lam, z_inner, R, np.abs(beta), np.where(beta >= 0, 1.0, -1.0)


@pytest.mark.parametrize("family,n,leaf,budget,resident", [
    ("uniform", 256, 32, 64, 0), ("uniform", 256, 32, 64, 1 << 20),
    ("glued_wilkinson", 252, 42, 64, 0), ("glued_wilkinson", 252, 42, 0, 0)])
def test_merge_level_matches_jax(family, n, leaf, budget, resident):
    args = _level_inputs(family, n, leaf, seed=5)
    # glued_wilkinson lanes hold undeflated near-duplicate pole pairs on
    # which the JAX package's 16-step iteration has not converged (ROADMAP
    # Queue 3); both packages get the converged budget there.
    niter = 40 if family == "glued_wilkinson" else 16
    kw = dict(niter=niter, stream_threshold=0, deflate_budget=budget,
              resident_threshold=resident)
    want = jmerge.merge_level(*(jnp.asarray(a) for a in args), **kw)
    got = tmerge.merge_level(*(torch.from_numpy(a) for a in args), **kw)
    np.testing.assert_allclose(got.rho_eff.numpy(), np.asarray(want.rho_eff),
                               rtol=1e-15, atol=0)
    if family == "uniform":
        np.testing.assert_array_equal(got.kprime.numpy(),
                                      np.asarray(want.kprime))
    else:
        # Exactly repeated poles (copies of one Wilkinson block) sit on the
        # close-pole threshold, where a one-ulp difference in z (its norm
        # is summed in another order) flips a deflation either way; both
        # choices are exact to the tolerance, and the spectra agree below.
        assert np.abs(got.kprime.numpy()
                      - np.asarray(want.kprime)).max() <= 4
    tol = 64 * np.finfo(np.float64).eps * max(1.0, np.abs(args[0]).max())
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               rtol=0, atol=tol)
    rows = got.rows.numpy()
    if family == "uniform":
        np.testing.assert_allclose(rows, np.asarray(want.rows), rtol=0,
                                   atol=1e-12)
    else:
        # Inside glued Wilkinson's clusters eigenvector entries may rotate
        # freely under one-ulp pole changes (see tests/test_deflation.py);
        # the rows stay rows of an orthogonal matrix.
        np.testing.assert_allclose(np.linalg.norm(rows, axis=-1), 1.0,
                                   atol=1e-10)


def test_merge_level_root_mode_and_batched_view():
    args = _level_inputs("uniform", 256, 32, seed=6)
    ta = [torch.from_numpy(a) for a in args]
    root = tmerge.merge_level(*ta, root_mode=True, stream_threshold=0,
                              resident_threshold=0)
    full = tmerge.merge_level(*ta, stream_threshold=0, resident_threshold=0)
    assert torch.equal(root.lam, full.lam)
    assert not root.rows.any()
    B = 2
    bat = tmerge.merge_level_batched(
        ta[0].reshape(B, 2, 2, 32), ta[1].reshape(B, 2, 2, 32),
        ta[2].reshape(B, 2, 2, 64), ta[3].reshape(B, 2), ta[4].reshape(B, 2),
        stream_threshold=0, resident_threshold=0)
    assert torch.equal(bat.lam.reshape(4, 64), full.lam)
    assert torch.equal(bat.rows.reshape(4, 2, 64), full.rows)


def test_forced_missed_rotation_takes_sequential_chain(monkeypatch):
    """A detected missed rotation routes the whole level to the
    sequential chain: the result equals deflate_budget=0 bit for bit."""
    args = [torch.from_numpy(a)
            for a in _level_inputs("glued_wilkinson", 256, 32, seed=7)]
    seq = tmerge.merge_level(*args, deflate_budget=0, stream_threshold=0,
                             resident_threshold=0)
    monkeypatch.setattr(
        tmerge, "_deflate_missed",
        lambda d0, *a: torch.ones(d0.shape[0], dtype=torch.bool))
    forced = tmerge.merge_level(*args, deflate_budget=64, stream_threshold=0,
                                resident_threshold=0)
    for a, b in zip(forced, seq):
        assert torch.equal(a, b)


def test_parallel_head_equals_sequential_chain_bitwise():
    """Eager torch does not contract the rotation arithmetic, so the
    restricted chain over the candidates is the sequential chain bit for
    bit on a rotation-heavy level."""
    args = [torch.from_numpy(a)
            for a in _level_inputs("glued_wilkinson", 252, 42, seed=8)]
    d, z, R, small, tol, _ = tmerge._merge_assemble(
        args[0][:, 0], args[0][:, 1], args[1][:, 0], args[1][:, 1], args[2],
        args[3], args[4], 8.0)
    par = tmerge._deflate_level(d, z, R, small, tol, budget=8)
    seq = tmerge._close_pole_scan(d, z, R, small, tol)
    for a, b in zip(par, seq):
        assert torch.equal(a, b)
    assert (par[3] & ~small).any()        # rotations did fire


@pytest.mark.parametrize("family,n,leaf", [("uniform", 64, 16),
                                           ("glued_wilkinson", 252, 42)])
def test_fused_false_merge_level_matches_jax(family, n, leaf):
    """The two-pass conquer (log-space weights, then the row update)
    against ``repro``'s fused=False level and the port's fused level."""
    args = _level_inputs(family, n, leaf, seed=9)
    niter = 40 if family == "glued_wilkinson" else 16
    kw = dict(niter=niter, stream_threshold=0, resident_threshold=0)
    want = jmerge.merge_level(*(jnp.asarray(a) for a in args), fused=False,
                              **kw)
    ta = [torch.from_numpy(a) for a in args]
    got = tmerge.merge_level(*ta, fused=False, **kw)
    fused = tmerge.merge_level(*ta, **kw)
    tol = 64 * np.finfo(np.float64).eps * max(1.0, np.abs(args[0]).max())
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got.lam.numpy(), fused.lam.numpy(), rtol=0,
                               atol=tol)
    assert torch.equal(got.kprime, fused.kprime)
    if family == "uniform":
        np.testing.assert_allclose(got.rows.numpy(), np.asarray(want.rows),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.rows.numpy(), fused.rows.numpy(),
                                   rtol=0, atol=1e-12)
    else:
        # Rows inside glued Wilkinson's clusters may rotate freely (see
        # test_merge_level_matches_jax); they stay unit rows.
        np.testing.assert_allclose(np.linalg.norm(got.rows.numpy(), axis=-1),
                                   1.0, atol=1e-10)


def test_more_rows_than_the_fused_kernels_take_run_two_pass():
    """r > FUSED_MAX_ROWS (the baselines' r = K) takes the two-pass route
    whatever ``fused`` says: equal to fused=False bit for bit."""
    lam, z_inner, R, rho, sgn = _level_inputs("uniform", 64, 16, seed=10)
    K = 2 * lam.shape[-1]
    eye = np.broadcast_to(np.eye(K), (R.shape[0], K, K)).copy()
    ta = [torch.from_numpy(a) for a in (lam, z_inner, eye, rho, sgn)]
    a = tmerge.merge_level(*ta, resident_threshold=1 << 20)
    b = tmerge.merge_level(*ta, fused=False)
    assert torch.equal(a.lam, b.lam) and torch.equal(a.rows, b.rows)


@pytest.mark.parametrize("K", [1, 2, 7, 64, 84])
def test_row_sums_depend_on_the_row_alone(K):
    """The z norm's fixed-order sum: a row's bits do not depend on the rows
    beside it (on the card ``torch.sum`` splits a row differently as the
    row count changes), and it is a sum to rounding."""
    # Entries over 17 decades: the order of the additions shows in the bits.
    x = torch.from_numpy(10.0 ** np.random.default_rng(0).uniform(
        -17, 0, (5, K)))
    got = tmerge._sum_rows(x)
    for i in range(5):
        assert torch.equal(tmerge._sum_rows(x[i:i + 1])[0], got[i])
    torch.testing.assert_close(got, x.sum(dim=1), rtol=1e-14, atol=0)
    if K == 7:      # halves added, the odd last column riding along
        a = x[0]
        want = ((a[0] + a[3]) + (a[2] + a[5])) + ((a[1] + a[4]) + a[6])
        assert torch.equal(got[0], want)
        left_to_right = a[0]
        for v in a[1:]:
            left_to_right = left_to_right + v
        assert not torch.equal(got[0], left_to_right)   # the order shows
