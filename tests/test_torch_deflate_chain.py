"""The DLAED2 close-pole deflation chain of the port on the CPU: the plain
chain (``repro_torch.core.merge._close_pole_scan`` and ``_deflate_level``)
and the algorithm of the card's kernel (``csrc/deflate_chain.cu``).

  * The port's plain chain and parallel head against ``repro.core.merge``'s
    (``_close_pole_scan`` vmapped, ``_deflate_level``) on the same numpy
    inputs -- every level's ``_merge_assemble`` output of a glued-Wilkinson,
    uniform and clustered solve, float64 and float32, W <= 16, K <= 512:
    the deflated masks equal; d, z and R within (rotations + 1) * 2 ulp of
    the lane's largest entry (``repro`` documents <= 1 ulp per rotation
    from XLA's FMA contraction; hypot differs between the math libraries
    by an ulp).
  * A numpy model of the kernel's window scan (window sizes 1, 7 and 32:
    test the window's poles against their predecessors, apply the first
    rotation that fires, restart after it) equal to ``_close_pole_scan``
    bit for bit on every level of a glued n = 1024 solve, on the edge
    cases (a rotation the CPU's parallel head misses, K = 2, all poles
    small, a small first pole, a tau == 0 pair) and in a hypothesis sweep.
    The model takes the plain chain's hypot (``merge._hypot``: on the CPU
    one formula for every element, since ATen's float64 hypot takes
    another code path for a vectorised block of lanes than for a lone
    element, and the two part by an ulp in some pairs); the plain chain
    runs one lane at a time there.

The card's twins (kernel == plain chain on the card bit for bit, batched
== one lane, one launch per level, no host sync) are ``gpu`` tests in
tests/test_torch_kernels.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import merge as jmerge  # noqa: E402
from repro_torch.core import eigvalsh_tridiagonal_batch  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core.tridiag import make_family  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


pytestmark = pytest.mark.deflation

DTYPES = {"float64": torch.float64, "float32": torch.float32}


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # One JAX executable per level shape and dtype; XLA:CPU keeps each
    # one's memory mappings for the life of the process (see
    # tests/test_torch_bisect.py).
    yield
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _levels(family, n, dtype):
    """Every level's chain inputs (d, z, R, small, tol) of the port's CPU
    solve of ``family`` at n (seed 0, leaf 32), as numpy arrays."""
    got = []
    real = tmerge._deflate_level

    def spy(d, z, R, small, tol, *, budget):
        got.append(tuple(t.numpy().copy() for t in (d, z, R, small, tol)))
        return real(d, z, R, small, tol, budget=budget)

    d, e = make_family(family, n, seed=0)
    tmerge._deflate_level = spy
    try:
        eigvalsh_tridiagonal_batch(d[None], e[None], leaf=32,
                                   dtype=DTYPES[dtype], device="cpu")
    finally:
        tmerge._deflate_level = real
    return tuple(got)


def _lane_tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---- the port's plain chain against repro's -------------------------------

_j_scan = jax.jit(jax.vmap(jmerge._close_pole_scan))
_j_level = jax.jit(functools.partial(jmerge._deflate_level, budget=64))


def _tie(d, z, small, tol, idx):
    """Whether the chain's decision on pole ``idx`` of one lane (made at
    the next kept pole's test) sits on the threshold within the rounding
    its predecessor's value may carry: (rotations + 1) * 2 ulp of the
    lane's largest pole, the bar the outputs are held to."""
    nk = idx + 1 + np.flatnonzero(~small[idx + 1:])[0]
    out = tmerge._close_pole_scan(*_lane_tensors(
        d[None, :nk], z[None, :nk], np.zeros((1, 1, nk), d.dtype),
        small[None, :nk], np.asarray([tol])))
    pd, pz = out[0][0, idx].item(), out[1][0, idx].item()
    rotations = int((out[3][0].numpy() & ~small[:nk]).sum())
    slack = (rotations + 1) * 2 * np.finfo(d.dtype).eps * np.abs(d).max()
    tau = np.hypot(pz, z[nk])
    cs = abs(float(z[nk]) * pz) / tau ** 2
    t = abs(float(d[nk]) - pd)
    return (t - slack) * cs <= tol <= (t + slack) * cs


def _hold(inputs, got, want, what):
    """The port's chain result ``got`` against ``repro``'s ``want`` lane by
    lane: equal deflated masks and d, z, R within (rotations + 1) * 2 ulp
    of the lane's largest entry.  Where a lane's masks part, the first
    decision that differs must be a tie (:func:`_tie`); the lanes part
    from there on.  Returns the number of such lanes."""
    d, z, R, small, tol = inputs
    gd, gz, gR, gdefl = (t.numpy() for t in got)
    wd, wz, wR, wdefl = (np.asarray(t) for t in want)
    eps = np.finfo(d.dtype).eps
    parted = 0
    for w in range(d.shape[0]):
        differ = np.flatnonzero(gdefl[w] != wdefl[w])
        if differ.size:
            assert _tie(d[w], z[w], small[w], tol[w], differ[0]), (
                what, w, differ[0])
            parted += 1
            continue
        rotations = int((gdefl[w] & ~small[w]).sum())
        for name, a, b in (("d", gd, wd), ("z", gz, wz), ("R", gR, wR)):
            bar = (rotations + 1) * 2 * eps * np.abs(b[w]).max()
            err = np.abs(a[w] - b[w]).max()
            assert err <= bar, (what, w, name, err, bar, rotations)
    return parted


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("family,n", [("glued_wilkinson", 1024),
                                      ("uniform", 512), ("clustered", 512)])
def test_plain_chain_and_level_match_jax(family, n, dtype):
    """Deflation decisions are threshold tests, and an ulp of difference
    in a rotated pole (XLA contracts the rotation into FMAs; the two hypot
    implementations differ) flips a test that sits on the threshold: such
    a lane is held up to its first decision that differs, which must be a
    tie; the rest of its chain is another chain (ROADMAP Queue 3 item 4).
    Every other lane is held whole."""
    levels = [lv for lv in _levels(family, n, dtype)
              if lv[0].shape[0] <= 16 and lv[0].shape[1] <= 512]
    assert len(levels) >= 3
    fired = lanes = parted = 0
    for lv in levels:
        what = f"{family} {dtype} W={lv[0].shape[0]} K={lv[0].shape[1]}"
        t = _lane_tensors(*lv)
        j = [jnp.asarray(a) for a in lv]
        seq = tmerge._close_pole_scan(*t)
        parted += _hold(lv, seq, _j_scan(*j), what + " chain")
        _hold(lv, tmerge._deflate_level(*t, budget=64), _j_level(*j),
              what + " level")
        fired += int((seq[3].numpy() & ~lv[3]).sum())
        lanes += lv[0].shape[0]
    if family == "glued_wilkinson":
        assert fired > 50                      # rotation-heavy levels
    if family == "uniform":
        assert parted == 0
    assert parted <= lanes // 2, (parted, lanes)


# ---- the kernel's window scan, modelled in numpy --------------------------

def _window_scan(d, z, R, small, tol, window):
    """The window scan of ``csrc/deflate_chain.cu`` on one lane, in numpy:
    d, z, small (K,), R (r, K), tol a scalar of d's dtype.  Returns (d, z,
    R, deflated, dependent steps)."""
    d, z, R, defl = d.copy(), z.copy(), R.copy(), small.copy()
    K = d.shape[0]
    one = d.dtype.type(1)
    cd = cz = d.dtype.type(0)
    cidx = -1
    start = steps = 0
    while start < K:
        steps += 1
        # Poles at or after ``start`` are untouched until their own step.
        di, zi = d[start:start + window], z[start:start + window]
        kept = ~small[start:start + window]
        lanes = np.arange(di.shape[0])
        last = np.maximum.accumulate(np.where(kept, lanes, -1))
        prev = np.concatenate([[-1], last[:-1]])
        inwin = prev >= 0
        pd = np.where(inwin, di[prev], cd)
        pz = np.where(inwin, zi[prev], cz)
        p = np.where(inwin, start + prev, cidx)
        tau = tmerge._hypot(torch.from_numpy(pz),
                            torch.from_numpy(zi)).numpy()
        tau_safe = np.where(tau > 0, tau, one)
        c = zi / tau_safe
        s = -pz / tau_safe
        close = (p >= 0) & kept & (np.abs(((di - pd) * c) * s) <= tol) & (
            tau > 0)
        if not close.any():
            if kept.any():
                k = np.flatnonzero(kept)[-1]
                cd, cz, cidx = di[k], zi[k], start + k
            start += window
            continue
        f = np.flatnonzero(close)[0]
        i, j = start + f, p[f]
        cf, sf, pdf, dif = c[f], s[f], pd[f], di[f]
        d_j = (pdf * cf) * cf + (dif * sf) * sf
        d_i = (pdf * sf) * sf + (dif * cf) * cf
        d[j], d[i] = d_j, d_i
        z[j], z[i] = 0, tau[f]
        a, b = R[:, j].copy(), R[:, i].copy()
        R[:, j] = cf * a + sf * b
        R[:, i] = -sf * a + cf * b
        defl[j] = True
        cd, cz, cidx = d_i, tau[f], i
        start = i + 1
    return d, z, R, defl, steps


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == np.bool_ else a.view(
        {8: np.uint64, 4: np.uint32}[a.itemsize])


def _assert_window_scan_is_chain(d, z, R, small, tol, window):
    got = _window_scan(d, z, R, small, tol, window)
    want = tmerge._close_pole_scan(*_lane_tensors(
        d[None], z[None], R[None], small[None], np.asarray([tol])))
    for name, a, b in zip("d z R deflated".split(), got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()[0]),
                                      err_msg=f"window {window}: {name}")
    return got


@pytest.mark.parametrize("window", [1, 7, 32])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_window_scan_is_the_chain_on_every_glued_level(window, dtype):
    rotations = 0
    for d, z, R, small, tol in _levels("glued_wilkinson", 1024, dtype):
        for w in range(d.shape[0]):
            out = _assert_window_scan_is_chain(d[w], z[w], R[w], small[w],
                                               tol[w], window)
            rotations += int((out[3] & ~small[w]).sum())
    assert rotations > 50


def _edge_cases(dtype):
    """(name, d, z, small, tol) lanes at the chain's edges."""
    t = lambda a: np.asarray(a, dtype=dtype)  # noqa: E731
    F, T = False, True
    return [
        # Pole 4 closes only after the rotations at 1, 2 and 3 have moved
        # its predecessor: a cascade deeper than the parallel head's two
        # successor hops, so the CPU head misses it and falls back.
        ("missed rotation", t([0, 0, 0.01, 0.02, 0.03, 1.0]),
         t([1, 0.01, 0.01, 0.01, 0.01, 0.01]), np.zeros(6, bool), 1e-3),
        ("K = 2", t([1.0, 1.0]), t([0.6, 0.8]), np.zeros(2, bool), 1e-12),
        ("all poles small", t(np.linspace(0, 1, 40)), t(np.zeros(40)),
         np.ones(40, bool), 1e-3),
        ("small first pole", t([0.5, 0.5, 0.5, 0.7]), t([0, 0.6, 0.8, 0.1]),
         np.array([T, F, F, F]), 1e-6),
        ("tau == 0 pair", t([1.0, 1.0, 1.0, 2.0]), t([0, 0, 0.5, 0.5]),
         np.zeros(4, bool), 1e-6),
    ]


def test_the_missed_rotation_case_defeats_the_parallel_head():
    _, d, z, small, tol = _edge_cases(np.float64)[0]
    t = _lane_tensors(d[None], z[None], small[None], np.asarray([tol]))
    cand, pk = tmerge._deflate_candidates(*t)
    R = torch.zeros((1, 2, d.shape[0]), dtype=torch.float64)
    count = cand.sum(dim=1)
    d1, z1, _, _ = tmerge._deflate_apply(t[0], t[1], R, t[2], t[3], pk, cand,
                                         count, steps=int(count.max()))
    assert tmerge._deflate_missed(t[0], t[1], d1, z1, t[2], t[3], pk,
                                  cand).all()


@pytest.mark.parametrize("window", [1, 7, 32])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_window_scan_is_the_chain_at_the_edges(window, dtype):
    rng = np.random.default_rng(11)
    for name, d, z, small, tol in _edge_cases(dtype):
        R = rng.standard_normal((3, d.shape[0])).astype(dtype)
        defl = _assert_window_scan_is_chain(d, z, R, small, dtype(tol),
                                            window)[3]
        if name == "all poles small":
            assert (defl == small).all(), name
        elif name == "tau == 0 pair":
            # (0, 1) has tau == 0 and stays; (1, 2) rotates with s == -0.
            assert defl.tolist() == [False, True, False, False], name
        elif name == "small first pole":
            # Pole 1 has no kept predecessor; (1, 2) rotates.
            assert defl.tolist() == [True, True, False, False], name
        else:
            assert (defl & ~small).any(), name


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), K=st.integers(2, 80),
       r=st.integers(1, 3), window=st.sampled_from([1, 7, 32]),
       dtype=st.sampled_from([np.float64, np.float32]))
def test_window_scan_is_the_chain_in_a_sweep(seed, K, r, window, dtype):
    rng = np.random.default_rng(seed)
    # Poles on a coarse grid plus tiny offsets: many exact and near ties.
    d = np.sort(rng.integers(0, 6, K) * 0.1
                + rng.uniform(0, 1e-4, K) * (rng.random(K) < 0.5))
    z = rng.standard_normal(K) * np.exp(rng.uniform(-4, 0, K))
    small = rng.random(K) < rng.uniform(0, 0.5)
    z[small] = 0.0
    z[rng.random(K) < 0.05] = 0.0            # kept poles with z == 0
    tol = 10.0 ** rng.uniform(-7, -2)
    R = rng.standard_normal((r, K))
    _assert_window_scan_is_chain(d.astype(dtype), z.astype(dtype),
                                 R.astype(dtype), small, dtype(tol), window)
