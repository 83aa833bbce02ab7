"""The team order of the weight and column kernels, and the CPU hypot of
the deflation chain.

  * numpy models of the order in which ``csrc/weights.cuh`` (zhat, and
    the fused post-pass's pass A) and the fused post-pass's pass B
    (``csrc/fused_update.cu``) combine their terms -- lane l of a team of
    TEAM takes the terms i = l (mod TEAM) in ascending order, then a fixed
    xor butterfly combines the lanes -- held to the plain versions
    (``repro_torch.core.secular``) at the tolerances of the card's kernel
    tests, float64 and float32 (float32 scaled by eps): on every level
    with rows of a uniform, clustered and glued-Wilkinson n = 1024 solve
    (K <= 512), and on a graded lane whose factors span fifteen decades.
    The weight model is the kernels' ratio product, the plain zhat the
    log-space form of ``repro``: the model shows that the ratio product
    meets the log form's bar.  The models take correctly rounded
    divisions where the kernels multiply by ``secular::rcp`` (the
    hardware estimate and Newton steps, within about an ulp of the
    correctly rounded reciprocal, so a product of K factors moves by some
    sqrt(K) ulps): they model the order of the terms, not the kernels'
    bits, and are held to the plain versions' bar, not to the kernels.
    Nor do they need the kernels' gap scaling (``secular::gap_scale``,
    which keeps a double lane's gaps where the estimate holds): a numpy
    division has no such limit.
  * the deflation chain's hypot on the CPU: ``_close_pole_scan`` gives the
    same bits whether a lane's poles are contiguous in memory or strided
    (ATen's float64 hypot takes a vectorised path for contiguous blocks
    and a scalar one otherwise, and the two part by an ulp in some pairs).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import eigvalsh_tridiagonal_batch  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.core.tridiag import make_family  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TEAM = 8                  # csrc/secular_common.cuh
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _tols(dtype):
    """Weights and rows: atol, rtol of tests/test_torch_kernels.py."""
    scale = (np.finfo(np.float32).eps / np.finfo(np.float64).eps
             if dtype == torch.float32 else 1.0)
    return 1e-12 * scale, 1e-10 * scale


# ---- the levels ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _levels(family, n, dtype):
    """Every level's two-pass inputs (d, z, origin, tau, kprime, rho) of
    the port's CPU solve of ``family`` at n with fused=False (seed 0,
    leaf 32), as numpy arrays."""
    got = []
    real = ops.zhat_reconstruct_batched

    def spy(d, z, origin, tau, kprime, rho, **kw):
        got.append(tuple(t.numpy().copy()
                         for t in (d, z, origin, tau, kprime, rho)))
        return real(d, z, origin, tau, kprime, rho, **kw)

    d, e = make_family(family, n, seed=0)
    ops.zhat_reconstruct_batched = spy
    try:
        eigvalsh_tridiagonal_batch(d[None], e[None], leaf=32, fused=False,
                                   dtype=DTYPES[dtype], device="cpu")
    finally:
        ops.zhat_reconstruct_batched = real
    return tuple(got)


def _graded_lane(dtype, K=512, seed=5):
    """One lane of K poles graded over nine decades around 0 and weights
    over six, rooted by the plain solve: its weight factors span some
    fifteen decades, the widest of the float32 lanes (a glued-Wilkinson
    K = 64 lane's span 33 in float64)."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-6, 3, K)
    d = np.sort(np.where(rng.random(K) < 0.5, -mag, mag))
    z = 10.0 ** rng.uniform(-6, 0, K) * np.where(rng.random(K) < 0.5, -1, 1)
    z /= np.linalg.norm(z)
    np_t = np.dtype(str(dtype).replace("torch.", ""))
    d, z = d.astype(np_t), z.astype(np_t)
    rho = np.asarray([1.3], np_t)
    kp = np.asarray([K], np.int32)
    t = [torch.from_numpy(a) for a in (d[None], z[None], rho, kp)]
    o, tau = tsec.secular_solve_batched(t[0], t[1] * t[1], t[2], t[3],
                                        niter=ops.resolve_niter(None, dtype))
    return (d[None], z[None], o.numpy(), tau.numpy(), kp, rho)


def _cases(dtype):
    tag = str(dtype).replace("torch.", "")
    for family, n in (("uniform", 1024), ("clustered", 1024),
                      ("glued_wilkinson", 1024)):
        for lv in _levels(family, n, tag):
            yield f"{family} W={lv[0].shape[0]} K={lv[0].shape[1]}", lv
    yield "graded K=512", _graded_lane(dtype)


# ---- the models ------------------------------------------------------------

def _butterfly(v, op):
    """Team::sum / Team::prod of secular_common.cuh: at each step lane l
    combines its value with lane l ^ s's (both get the same bits)."""
    lanes = np.arange(TEAM)
    s = 1
    while s < TEAM:
        v = op(v, v[..., lanes ^ s])
        s <<= 1
    return v[..., 0]


def _weights_model(d, z, origin, tau, kprime, rho):
    """zhat of weights.cuh for one lane (1-D arrays of the input type):
    lane l of pole i's team multiplies secular::weight_factor of its roots
    j = l (mod TEAM), j != i, in ascending order, in float64; the
    butterfly combines products and floored counts; weight_z2 and the
    sign finish.  Each factor is a correctly rounded division, where the
    kernel multiplies by rcp (see the module's docstring).  Returns
    (zhat, log10 of the largest over the smallest factor)."""
    K = d.shape[0]
    kp = int(kprime)
    T = d.dtype.type
    tiny = float(np.finfo(d.dtype).tiny)
    out = z.copy()
    if kp == 0:
        return out, 0.0
    o = np.minimum(origin[:kp], K - 1)
    dorg, di = d[o], d[:kp]
    lam = ((dorg[None, :] - di[:, None]) + tau[None, :kp])   # (i, j), in T
    gap = d[None, :kp] - di[:, None]
    a = np.abs(lam.astype(np.float64))
    b = np.abs(gap.astype(np.float64))
    fa, fb = a < tiny, b < tiny
    self_ = np.eye(kp, dtype=bool)
    fac = np.where(fa, 1.0, a) / np.where(fb, 1.0, b)
    fac = np.where(self_, 1.0, fac)
    flo = np.where(self_, 0, fa.astype(np.int64) - fb.astype(np.int64))
    span = np.log10(fac.max() / fac.min())
    pad = -kp % TEAM
    fac = np.pad(fac, ((0, 0), (0, pad)), constant_values=1.0)
    flo = np.pad(flo, ((0, 0), (0, pad)))
    fac = fac.reshape(kp, -1, TEAM)          # [pole, round, lane]
    prod = np.ones((kp, TEAM))
    for step in range(fac.shape[1]):
        prod = prod * fac[:, step, :]
    prod = _butterfly(prod, np.multiply)
    floored = _butterfly(flo.reshape(kp, -1, TEAM).sum(1), np.add)
    sa = np.abs(np.diag(lam).astype(np.float64))
    floored = floored + (sa < tiny)
    sa = np.where(sa < tiny, 1.0, sa)
    z2 = prod * sa / float(rho)
    z2 = np.where(floored == 0, z2, z2 * np.power(tiny, floored * 1.0))
    out[:kp] = np.sign(z[:kp]) * np.sqrt(z2).astype(T)
    return out, span


def _columns_model(R, d, w, origin, tau, kprime):
    """rows of pass B for one lane: lane l of column j's team sums its
    poles i = l (mod TEAM) in ascending order, the butterfly combines,
    and the column is divided by its norm (an exact zero denominator
    divides by 1).  R (r, K); the sums run in the input type."""
    K = d.shape[0]
    kp = int(kprime)
    rows = R.copy()
    if kp == 0:
        return rows
    o = np.minimum(origin[:kp], K - 1)
    delta = (d[:kp, None] - d[o][None, :]) - tau[None, :kp]   # (i, j)
    one = d.dtype.type(1)
    y = w[:kp, None] * (one / np.where(delta != 0, delta, one))
    pad = -kp % TEAM
    yp = np.pad(y, ((0, pad), (0, 0)))
    Rp = np.pad(R[:, :kp], ((0, 0), (0, pad)))
    acc = np.zeros((R.shape[0], kp, TEAM), d.dtype)     # [q, column, lane]
    nrm2 = np.zeros((kp, TEAM), d.dtype)
    for step in range(yp.shape[0] // TEAM):
        blk = yp[step * TEAM:(step + 1) * TEAM].T       # [column, lane]
        acc = acc + Rp[:, None, step * TEAM:(step + 1) * TEAM] * blk[None]
        nrm2 = nrm2 + blk * blk
    acc = _butterfly(acc, np.add)
    nrm = np.sqrt(_butterfly(nrm2, np.add))
    rows[:, :kp] = acc / np.where(nrm > 0, nrm, one)
    return rows


# ---- the models against the plain versions ---------------------------------

def _close(got, want, atol, rtol, what):
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bar = atol + rtol * np.abs(want.astype(np.float64))
    assert np.isfinite(got).all(), what
    assert (err <= bar).all(), (what, float(err.max()),
                                float((err - bar).max()))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_weight_model_meets_the_plain_bar(dtype):
    """The ratio product in team order against the plain log-space zhat
    and against the plain fused post-pass's ratio-product weights."""
    atol, rtol = _tols(dtype)
    widest = 0.0
    n = 0
    for what, (d, z, o, t, kp, rho) in _cases(dtype):
        tt = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (d, z, o, t, kp, rho)]
        want = tsec.zhat_reconstruct_batched(*tt).numpy()
        R = torch.zeros((d.shape[0], 1, d.shape[1]), dtype=dtype)
        fused, _ = tsec.secular_postpass_batched(R, *tt)
        for w in range(d.shape[0]):
            got, span = _weights_model(d[w], z[w], o[w], t[w], kp[w], rho[w])
            _close(got, want[w], atol, rtol, f"{what} lane {w} log")
            _close(got, fused.numpy()[w], atol, rtol, f"{what} lane {w}")
            widest = max(widest, span)
            n += 1
    assert n > 40
    assert widest > 12          # some lane's factors span 12 decades


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_column_model_meets_the_plain_bar(dtype):
    """Pass B's team order against the plain row update and the plain
    fused post-pass, r = 3, on the weights of the plain post-pass."""
    atol, rtol = _tols(dtype)
    rng = np.random.default_rng(3)
    n = 0
    for what, (d, z, o, t, kp, rho) in _cases(dtype):
        R = rng.standard_normal((d.shape[0], 3, d.shape[1])).astype(d.dtype)
        tt = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (R, d, z, o, t, kp, rho)]
        w, rows = tsec.secular_postpass_batched(*tt)
        two_pass = tsec.boundary_rows_update_batched(tt[0], tt[1], w, tt[3],
                                                     tt[4], tt[5])
        for lane in range(d.shape[0]):
            got = _columns_model(R[lane], d[lane], w.numpy()[lane], o[lane],
                                 t[lane], kp[lane])
            _close(got, rows.numpy()[lane], atol, rtol, f"{what} {lane}")
            _close(got, two_pass.numpy()[lane], atol, rtol,
                   f"{what} {lane} two-pass")
            n += 1
    assert n > 40


def test_butterfly_gives_every_lane_the_same_bits():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((1000, TEAM))
    lanes = np.arange(TEAM)
    for op in (np.add, np.multiply):
        w = v.copy()
        s = 1
        while s < TEAM:
            w = op(w, w[:, lanes ^ s])
            s <<= 1
        assert (w == w[:, :1]).all()
        np.testing.assert_array_equal(_butterfly(v, op), w[:, 0])


# ---- the deflation chain's hypot on the CPU ---------------------------------

def _hypot_pairs(count, seed=17):
    """``count`` (a, b) pairs, first those on which torch's CPU float64
    hypot gives other bits on a contiguous block than element by element
    (none where the CPU has no vector path)."""
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((2, 200_000))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    block = torch.hypot(ta, tb).numpy()
    strided = torch.hypot(torch.stack([ta, tb], 1)[:, 0],
                          torch.stack([tb, ta], 1)[:, 0]).numpy()
    parted = np.flatnonzero(block != strided)
    order = np.concatenate([parted, np.setdiff1d(np.arange(a.size),
                                                 parted)])[:count]
    return a[order], b[order]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_close_pole_scan_does_not_depend_on_the_lane_layout(dtype):
    """W = 64 lanes of K = 3 poles whose first two poles coincide (the
    rotation fires, and the rotated pole's z is hypot(z_0, z_1)), once
    with each lane's poles contiguous and once with the lanes' poles
    interleaved (a pole's W lanes contiguous, so the chain's hypot sees
    contiguous blocks): the same bits."""
    W, K = 64, 3
    pz, zi = _hypot_pairs(W)
    rng = np.random.default_rng(2)
    d = np.sort(rng.standard_normal((W, K)), axis=1)
    d[:, 1] = d[:, 0]
    z = np.stack([pz, zi, rng.standard_normal(W)], 1)
    R = rng.standard_normal((W, 2, K))
    small = np.zeros((W, K), bool)
    tol = np.full(W, 1e-8)
    rows = [torch.from_numpy(a) for a in (d, z, R, small, tol)]
    rows = [t.to(dtype) if t.is_floating_point() else t for t in rows]
    cols = [t.transpose(0, -1).contiguous().transpose(0, -1)
            for t in rows[:4]] + [rows[4]]
    assert not cols[1].is_contiguous() and cols[1][:, 1].is_contiguous()
    a = tmerge._close_pole_scan(*rows)
    b = tmerge._close_pole_scan(*cols)
    assert bool(a[3][:, 0].all())            # every lane rotated
    for name, x, y in zip("d z R deflated".split(), a, b):
        assert torch.equal(x, y), name
    # ... and each lane alone (W = 1) agrees with the batch.
    for w in range(0, W, 7):
        one = tmerge._close_pole_scan(*(t[w:w + 1] for t in rows))
        for name, x, y in zip("d z R deflated".split(), a, one):
            assert torch.equal(x[w:w + 1], y), (name, w)
