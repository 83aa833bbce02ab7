"""The split route of the deflation chain kernel (``csrc/deflate_chain.cu``)
on the CPU: the rotation list, then R's rows.

The card's split route has one warp a lane decide the rotations and write
them as a list, then applies the list to R's rows across the card, each
thread taking one row and a share of the lane's cascades (runs of
rotations where rotation j + 1's p is rotation j's f).  Its bits rest on
two facts, held here with a numpy model of the split:

  * the model -- record the plain chain's rotations (p, f, c, s), then
    apply them to R one row at a time and one cascade at a time, in a
    shuffled cascade order, reading the input and carrying the cascade's
    running column -- equals ``merge._close_pole_scan`` bit for bit (d,
    z, R, mask) on every level's chain inputs of small lazy and
    full-vector solves (R = I and the block-diagonal Q of
    ``core/baselines.py``), on the edge lanes of
    tests/test_torch_deflate_chain.py and in a hypothesis sweep;
  * cascades touch disjoint columns, each in increasing order, and every
    column of a later cascade lies above the earlier ones.

The model's rotations are also held to ``repro.core.merge.
_close_pole_scan`` on the uniform levels (the same masks; d, z and R
within (rotations + 1) * 2 ulp, as tests/test_torch_deflate_chain.py
holds the plain chain).  And the pure ``kernels.deflate_chain.
launch_shape`` is held to the card's limits and to the route switch.
The card's twins are the ``gpu`` tests of tests/test_torch_kernels.py.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import merge as jmerge  # noqa: E402
from repro_torch.core import eigvalsh_tridiagonal  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core.tridiag import make_family  # noqa: E402
from repro_torch.kernels import deflate_chain as dck  # noqa: E402

pytestmark = pytest.mark.deflation

DTYPES = {"float64": torch.float64, "float32": torch.float32}
SOURCE = Path(dck.__file__).resolve().parents[1] / "csrc" / "deflate_chain.cu"


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # XLA:CPU keeps each executable's memory mappings for the life of the
    # process (see tests/test_torch_bisect.py).
    yield
    jax.clear_caches()


# ---- the model ------------------------------------------------------------

def _hypot(a, b):
    """The plain chain's hypot on the CPU (``merge._hypot``), on scalars."""
    return tmerge._hypot(torch.tensor([a]), torch.tensor([b])).numpy()[0]


def _record(d, z, small, tol):
    """The plain chain's decisions on one lane, in numpy: d, z, small (K,),
    tol a scalar of d's dtype.  Returns (d, z, deflated, rotations), the
    rotations a list of (p, f, c, s) in chain order."""
    d, z, defl = d.copy(), z.copy(), small.copy()
    one = d.dtype.type(1)
    rotations = []
    p = -1                                  # the carried (last kept) pole
    for i in range(d.shape[0]):
        if small[i]:
            continue
        if p >= 0:
            pd, pz, d_i, z_i = d[p], z[p], d[i], z[i]
            tau = _hypot(pz, z_i)
            tau_safe = tau if tau > 0 else one
            c = z_i / tau_safe
            s = -pz / tau_safe
            if abs(((d_i - pd) * c) * s) <= tol and tau > 0:
                d[p] = (pd * c) * c + (d_i * s) * s
                d[i] = (pd * s) * s + (d_i * c) * c
                z[p], z[i] = 0, tau
                defl[p] = True
                rotations.append((p, i, c, s))
        p = i
    return d, z, defl, rotations


def _cascades(rotations):
    """The list's cascades: runs of rotation indices where each rotation's
    p is the previous one's f."""
    out = []
    for j, (p, _, _, _) in enumerate(rotations):
        if j and p == rotations[j - 1][1]:
            out[-1].append(j)
        else:
            out.append([j])
    return out


def _apply(R, rotations, rng):
    """The split route's application on one lane, in numpy: R (r, K); each
    row alone, its cascades in a shuffled order, each cascade reading the
    input and carrying its running column, as a thread of the card's
    second launch does.  Returns the new R."""
    out = R.copy()
    cascades = _cascades(rotations)
    for k in rng.permutation(R.shape[0]):
        row, new = R[k], out[k]
        for ci in rng.permutation(len(cascades)):
            carry = None
            for j in cascades[ci]:
                p, f, c, s = rotations[j]
                a = row[p] if carry is None else carry
                b = row[f]
                new[p] = c * a + s * b
                carry = -s * a + c * b
            new[f] = carry
    return out


def _split(d, z, R, small, tol, seed=0):
    """The model of the split route on W lanes: (d, z, R, deflated)."""
    rng = np.random.default_rng(seed)
    outs = [[], [], [], []]
    for w in range(d.shape[0]):
        dw, zw, defl, rot = _record(d[w], z[w], small[w], tol[w])
        for o, x in zip(outs, (dw, zw, _apply(R[w], rot, rng), defl)):
            o.append(x)
    return tuple(np.stack(o) for o in outs)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == np.bool_ else a.view(
        {8: np.uint64, 4: np.uint32}[a.itemsize])


def _assert_split_is_chain(d, z, R, small, tol, seed=0):
    got = _split(d, z, R, small, tol, seed)
    want = tmerge._close_pole_scan(*(torch.from_numpy(np.ascontiguousarray(
        a)) for a in (d, z, R, small, tol)))
    for name, a, b in zip("d z R deflated".split(), got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()),
                                      err_msg=name)
    return got


@functools.lru_cache(maxsize=None)
def _levels(family, method, dtype):
    """Every level's chain inputs (d, z, R, small, tol) of the port's CPU
    ``method`` solve of ``family`` at n = 256 (seed 0, leaf 32), as numpy
    arrays: R = I for "lazy", the block-diagonal Q for "full" (columns
    in the sorted poles' order)."""
    got = []
    real = tmerge._deflate_level

    def spy(d, z, R, small, tol, *, budget):
        got.append(tuple(t.numpy().copy() for t in (d, z, R, small, tol)))
        return real(d, z, R, small, tol, budget=budget)

    d, e = make_family(family, 256, seed=0)
    tmerge._deflate_level = spy
    try:
        eigvalsh_tridiagonal(d, e, method=method, dtype=DTYPES[dtype],
                             device="cpu")
    finally:
        tmerge._deflate_level = real
    return tuple(got)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["lazy", "full"])
@pytest.mark.parametrize("family", ["glued_wilkinson", "uniform"])
def test_split_is_the_chain_on_every_baseline_level(family, method, dtype):
    levels = _levels(family, method, dtype)
    assert [lv[2].shape[1:] for lv in levels] == [(64, 64), (128, 128),
                                                 (256, 256)]
    rotations = 0
    for k, lv in enumerate(levels):
        R = lv[2]
        # The head has sorted the poles: R's columns come permuted.
        if method == "lazy":                # I
            assert ((R == 0) | (R == 1)).all() and (R.sum(axis=2) == 1).all()
        else:                               # block-diagonal Q_L (+) Q_R
            h = R.shape[1] // 2
            nz = R != 0
            assert not (nz[:, :h].any(axis=1) & nz[:, h:].any(axis=1)).any()
        got = _assert_split_is_chain(*lv, seed=k)
        rotations += int((got[3] & ~lv[3]).sum())
    if family == "glued_wilkinson" and dtype == "float64":
        assert rotations > 50


def _edge_cases(dtype):
    """(name, d, z, small, tol) lanes at the chain's edges, those of
    tests/test_torch_deflate_chain.py."""
    t = lambda a: np.asarray(a, dtype=dtype)  # noqa: E731
    F, T = False, True
    return [
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


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_split_is_the_chain_at_the_edges(dtype):
    rng = np.random.default_rng(11)
    lists = {}
    for name, d, z, small, tol in _edge_cases(dtype):
        R = rng.standard_normal((1, 3, d.shape[0])).astype(dtype)
        _assert_split_is_chain(d[None], z[None], R, small[None],
                               np.asarray([tol], dtype=dtype))
        lists[name] = _record(d, z, small, dtype(tol))[3]
    pairs = {k: [(p, f) for p, f, _, _ in v] for k, v in lists.items()}
    # The missed rotation is one cascade of four; the small first pole
    # has no predecessor; the tau == 0 pair does not rotate.
    assert pairs["missed rotation"] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert len(_cascades(lists["missed rotation"])) == 1
    assert pairs["small first pole"] == [(1, 2)]
    assert pairs["tau == 0 pair"] == [(1, 2)]
    assert pairs["all poles small"] == []


def _columns_of_cascades(rotations):
    """Each cascade's columns, in the order it touches them."""
    out = []
    for cas in _cascades(rotations):
        cols = [rotations[cas[0]][0]] + [rotations[j][1] for j in cas]
        out.append(cols)
    return out


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), K=st.integers(2, 96),
       r=st.integers(1, 6), small_share=st.floats(0.0, 0.6),
       dtype=st.sampled_from([np.float64, np.float32]))
def test_cascades_touch_disjoint_columns_in_a_sweep(seed, K, r, small_share,
                                                    dtype):
    rng = np.random.default_rng(seed)
    # Poles on a coarse grid plus tiny offsets: many exact and near ties,
    # so long cascades and short ones.
    d = np.sort(rng.integers(0, 6, K) * 0.1
                + rng.uniform(0, 1e-4, K) * (rng.random(K) < 0.5))
    z = rng.standard_normal(K) * np.exp(rng.uniform(-4, 0, K))
    small = rng.random(K) < small_share
    z[small] = 0.0
    tol = dtype(10.0 ** rng.uniform(-7, -2))
    d, z = d.astype(dtype), z.astype(dtype)
    rotations = _record(d, z, small, tol)[3]
    columns = _columns_of_cascades(rotations)
    flat = [c for cols in columns for c in cols]
    # Disjoint, and increasing within and across cascades: a later
    # cascade's columns all lie above every earlier one's.
    assert flat == sorted(set(flat))
    assert not small[flat].any()
    R = rng.standard_normal((1, r, K)).astype(dtype)
    _assert_split_is_chain(d[None], z[None], R, small[None],
                           np.asarray([tol]), seed=seed)


# ---- the model's rotations against repro's chain --------------------------

_j_scan = jax.jit(jax.vmap(jmerge._close_pole_scan))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["lazy", "full"])
def test_split_matches_jax_on_the_uniform_levels(method, dtype):
    """The same masks as ``repro``'s chain on the same numpy inputs, and
    d, z and R within (rotations + 1) * 2 ulp of the lane's largest entry
    (XLA contracts the rotation into FMAs; the math libraries' hypot
    differs by an ulp): the bar tests/test_torch_deflate_chain.py holds
    the plain chain to."""
    eps = np.finfo(np.dtype(dtype)).eps
    for lv in _levels("uniform", method, dtype):
        got = _split(*lv)
        want = [np.asarray(a) for a in _j_scan(*(jnp.asarray(x)
                                                 for x in lv))]
        np.testing.assert_array_equal(got[3], want[3])
        for w in range(lv[0].shape[0]):
            rotations = int((got[3][w] & ~lv[3][w]).sum())
            for a, b in zip(got[:3], want[:3]):
                bar = (rotations + 1) * 2 * eps * np.abs(b[w]).max()
                assert np.abs(a[w] - b[w]).max() <= bar


# ---- the launch shape -----------------------------------------------------

def _source_constants():
    text = SOURCE.read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in ("WARPS", "APPLY_THREADS", "MAX_SEGMENTS")}


def test_launch_constants_are_the_sources():
    assert _source_constants() == {"WARPS": dck.WARPS,
                                   "APPLY_THREADS": dck.APPLY_THREADS,
                                   "MAX_SEGMENTS": dck.MAX_SEGMENTS}
    # Neither launch takes shared memory: far inside Hopper's 227 KB a
    # block, whatever the shape.
    assert "__shared__" not in SOURCE.read_text()


def _level_shapes():
    """(W, r, K) of every level the card's chain takes: the BR solves
    (r = 2, 3) at n = 16384 and B = 64 x 4096, the lazy and full
    baselines (r = K) at n = 4096 and 16384, and the tests' r."""
    out = set()
    for n, B in ((16384, 1), (4096, 64), (4096, 1)):
        K = 64
        while K <= n:
            W = B * n // K
            for r in (1, 2, 3, 4, 5, 32, 33, 64, K):
                out.add((W, r, K))
            K *= 2
    return sorted(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_shape_fits_the_card_and_switches_at_the_threshold(dtype):
    for W, r, K in _level_shapes():
        s = dck.launch_shape(W, r, K, dtype)
        assert s == dck.launch_shape(W, r, K, dtype)          # pure
        assert s.threads == dck.WARPS * 32 <= 1024
        assert (s.chain_blocks - 1) * dck.WARPS < W <= (s.chain_blocks
                                                        * dck.WARPS)
        grids = [(s.chain_blocks + s.copy_blocks, 1, 1), s.apply_grid]
        for grid in grids:
            assert all(g <= lim for g, lim in zip(grid, dck.GRID_LIMIT))
        assert s.route == ("fused" if r < dck.SPLIT_MIN_R else "split")
        if s.route == "fused":
            assert (s.copy_blocks, s.apply_threads, s.apply_grid) == (
                0, 0, (0, 0, 0))
            continue
        Wg, tiles, S = s.apply_grid
        assert Wg == W and s.apply_threads == dck.APPLY_THREADS
        assert (tiles - 1) * dck.APPLY_THREADS < r <= tiles * (
            dck.APPLY_THREADS)
        assert 1 <= s.copy_blocks <= dck.COPY_BLOCKS
        assert S & (S - 1) == 0 and 1 <= S <= min(dck.MAX_SEGMENTS, K // 2)
        assert (W * r * S >= dck.APPLY_TARGET
                or S == min(dck.MAX_SEGMENTS, K // 2))
        assert S == 1 or W * r * (S // 2) < dck.APPLY_TARGET


def test_launch_shape_route_switch_and_forced_shapes():
    t = dck.SPLIT_MIN_R
    assert dck.launch_shape(1, t - 1, 4096, torch.float64).route == "fused"
    assert dck.launch_shape(1, t, 4096, torch.float64).route == "split"
    # The main path's rows take the fused route; the baselines' r = K the
    # split one.
    assert dck.launch_shape(64, 3, 2048, torch.float64).route == "fused"
    s = dck.launch_shape(1, 4096, 4096, torch.float64)
    assert s.route == "split" and s.apply_grid == (1, 32, 4)
    # Forced shapes (tests and the timing sweep) keep the source's limits.
    for route in ("fused", "split"):
        f = dck._shape(3, 5, 512, torch.float32, route)
        assert f.route == route and f.chain_blocks == 1
    assert dck._shape(1, 4096, 4096, torch.float64, "split",
                      segments=4).apply_grid == (1, 32, 4)
