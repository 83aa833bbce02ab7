"""The bisection tree (``core.bisect.bisect_tree_plain``, the plain version
of the ``sturm_bisect_tree`` kernel) on the CPU: the port only, no JAX.

  * One tree launch of depth m walking s <= m steps gives the same lo and
    hi as s trips of the bisection host loop, bit for bit, at depths 1, 2,
    3, 5 and 8, in float64 and float32, on uniform, glued-Wilkinson and
    clustered-duplicate problems, past convergence (frozen brackets stay
    frozen) and where brackets freeze in the middle of a launch.
  * Batched launches equal looped ones.
  * ``_slice_targets`` (range, edges and bisect solves) gives the same
    bits at any depth as at depth 1, and never runs more than ``maxiter``
    halvings.
  * The depth rule stays within [1, 8]; the count sweeps' launch shape.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (SolveRequest, eigvalsh_tridiagonal,  # noqa: E402
                              eigvalsh_tridiagonal_range, execute_request,
                              make_family, make_family_batch)
from repro_torch.core import bisect as tbis  # noqa: E402
from repro_torch.core import tune  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sturm_count import (  # noqa: E402
    launch_shape, sturm_bisect_tree_cuda)

DEPTHS = [1, 2, 3, 5, 8]
DTYPES = [torch.float64, torch.float32]
FAMILIES = ["uniform", "glued_wilkinson", "clustered"]
HALVINGS = 72            # past float64's convergence (~55 halvings here)


def _problem(family, dtype, n=40, B=2, k=6):
    """(d, e2, pivmin, tol, targets, lo, hi) as ``_slice_targets`` builds
    them.  "clustered": duplicated diagonal entries with tiny couplings,
    so several targets share nearly one eigenvalue."""
    if family == "clustered":
        rng = np.random.default_rng(7)
        d = np.repeat(rng.standard_normal((B, n // 4)), 4, axis=1)
        e = np.full((B, n - 1), 1e-9)
    else:
        d, e = make_family_batch(family, n, B, seed0=3)
    d = torch.tensor(d, dtype=dtype)
    e = torch.tensor(e, dtype=dtype)
    e2 = e * e
    pivmin = tbis._pivot_floor(e2)
    glo, ghi = tbis._gershgorin(d, e.abs(), pivmin)
    scale = torch.maximum(glo.abs(), ghi.abs())
    tol = (2.0 * torch.finfo(dtype).eps
           * scale.clamp(min=torch.finfo(dtype).tiny) + 2.0 * pivmin)
    targets = torch.tensor(np.stack([np.linspace(0, n - 1, k).round()] * B),
                           dtype=torch.int32)
    targets[:, 1] = targets[:, 2]                     # a repeated target
    return (d, e2, pivmin, tol, targets, glo.expand(B, k).contiguous(),
            ghi.expand(B, k).contiguous())


def _loop_trips(d, e2, pivmin, tol, targets, lo, hi, trips):
    """The bisection host loop, one count sweep a trip: [(lo, hi)] after
    each trip."""
    out = []
    for _ in range(trips):
        mid = 0.5 * (lo + hi)
        above = tbis.sturm_count_plain(d, e2, mid, pivmin) > targets
        live = (hi - lo) > tol
        hi = torch.where(above & live, mid, hi)
        lo = torch.where(~above & live, mid, lo)
        out.append((lo, hi))
    return out


@functools.lru_cache(maxsize=None)
def _reference(family, dtype):
    prob = _problem(family, dtype)
    return prob, _loop_trips(*prob, HALVINGS)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_tree_trip_equals_the_host_loop_bitwise(family, dtype, depth):
    (d, e2, pivmin, tol, targets, lo, hi), trips = _reference(family, dtype)
    it = 0
    while it < HALVINGS:
        steps = min(depth, HALVINGS - it)
        lo, hi, counts = tbis.bisect_tree_plain(d, e2, pivmin, tol, targets,
                                                lo, hi, depth=depth,
                                                steps=steps)
        it += steps
        want_lo, want_hi = trips[it - 1]
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi), it
        assert counts.shape == targets.shape + (2 ** depth - 1,)
    # the reference did converge, so frozen brackets were walked too
    assert not bool(((hi - lo) > tol).any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_brackets_that_freeze_inside_a_launch(dtype):
    """A tolerance that stops every bracket after 3 or 4 of a launch's 8
    halvings (and problems that stop at different steps) leaves lo and hi
    where the loop leaves them."""
    d, e2, pivmin, _, targets, lo, hi = _problem("uniform", dtype)
    width = hi - lo
    tol = width[:, :1] / torch.tensor([[10.0], [6.0]], dtype=dtype)
    (want_lo, want_hi), = _loop_trips(d, e2, pivmin, tol, targets, lo, hi,
                                      8)[-1:]
    got_lo, got_hi, _ = tbis.bisect_tree_plain(d, e2, pivmin, tol, targets,
                                               lo, hi, depth=8, steps=8)
    assert torch.equal(got_lo, want_lo) and torch.equal(got_hi, want_hi)
    halvings = torch.log2(width / (got_hi - got_lo)).round()
    assert set(halvings[0].tolist()) == {4.0}
    assert set(halvings[1].tolist()) == {3.0}


def test_tree_batched_equals_looped():
    d, e2, pivmin, tol, targets, lo, hi = _problem("glued_wilkinson",
                                                   torch.float64, B=3)
    whole = tbis.bisect_tree_plain(d, e2, pivmin, tol, targets, lo, hi,
                                   depth=5, steps=5)
    for b in range(3):
        sl = slice(b, b + 1)
        one = tbis.bisect_tree_plain(d[sl], e2[sl], pivmin[sl], tol[sl],
                                     targets[sl], lo[sl], hi[sl], depth=5,
                                     steps=5)
        for a, w in zip(one, whole):
            assert torch.equal(a[0], w[b])


def test_cpu_tensors_take_the_plain_tree():
    d, e2, pivmin, tol, targets, lo, hi = _problem("uniform", torch.float64)
    before = sturm_bisect_tree_cuda.launches
    got = ops.bisect_tree_batched(d, e2, pivmin, tol, targets, lo, hi,
                                  depth=3, steps=2)
    want = tbis.bisect_tree_plain(d, e2, pivmin, tol, targets, lo, hi,
                                  depth=3, steps=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sturm_bisect_tree_cuda(d, e2, pivmin[:, 0], tol[:, 0], targets, lo,
                               hi, depth=3, steps=2)
    assert sturm_bisect_tree_cuda.launches == before


# ------------------------------------------------------- the host loop


def _force_depth(monkeypatch, brackets, depth):
    """Make the CPU's depth rule give ``depth`` for ``brackets`` brackets:
    exactly the tree's node chains fit."""
    monkeypatch.setitem(tune._DEFAULTS["cpu"], "bisect_chains",
                        brackets * (2 ** depth - 1))
    assert tune.bisect_depth(brackets, tune.backend_defaults("cpu")[
        "bisect_chains"]) == depth


@pytest.mark.parametrize("depth", [2, 3, 5, 8])
def test_slice_targets_same_bits_at_every_depth(monkeypatch, depth):
    D, E = make_family_batch("glued_wilkinson", 40, 2, seed0=5)
    d, e = torch.tensor(D), torch.tensor(E)
    targets = torch.tensor([[0, 3, 17, 39]] * 2, dtype=torch.int32)
    want = tbis._slice_targets(d, e, targets)
    want13 = tbis._slice_targets(d, e, targets, maxiter=13)
    _force_depth(monkeypatch, 8, depth)
    assert torch.equal(tbis._slice_targets(d, e, targets), want)
    assert torch.equal(tbis._slice_targets(d, e, targets, maxiter=13),
                       want13)


def test_maxiter_13_at_depth_8_runs_13_halvings(monkeypatch):
    D, E = make_family_batch("uniform", 40, 2, seed0=6)
    d, e = torch.tensor(D), torch.tensor(E)
    targets = torch.tensor([[1, 20]] * 2, dtype=torch.int32)
    steps = []
    real = ops.bisect_tree_batched

    def spy(*a, depth, steps=None, **k):
        spy.log.append((depth, steps))
        return real(*a, depth=depth, steps=steps, **k)
    spy.log = steps
    monkeypatch.setattr(ops, "bisect_tree_batched", spy)
    _force_depth(monkeypatch, 4, 8)
    tbis._slice_targets(d, e, targets, maxiter=13)
    assert steps == [(8, 8), (8, 5)]
    steps.clear()
    _force_depth(monkeypatch, 4, 3)
    tbis._slice_targets(d, e, targets, maxiter=13)
    assert steps == [(3, 3)] * 4 + [(3, 1)]


def test_entry_points_same_bits_at_the_cards_depth(monkeypatch):
    """Range, edges and bisect solves at the depth the card's rule picks
    (chains for depth 8) equal the CPU's depth-1 solves bit for bit."""
    d, e = make_family("uniform", 40, seed=9)
    D, E = make_family_batch("normal", 40, 2, seed0=9)

    def solve():
        return (eigvalsh_tridiagonal_range(d, e, il=3, iu=10, device="cpu"),
                execute_request(SolveRequest(d=D, e=E, kind="edges",
                                             knobs={"k": 3},
                                             device="cpu")).eigenvalues,
                eigvalsh_tridiagonal(d, e, method="bisect", device="cpu"))
    want = solve()
    depths = []
    real = ops.bisect_tree_batched

    def spy(*a, depth, **k):
        depths.append(depth)
        return real(*a, depth=depth, **k)
    monkeypatch.setattr(ops, "bisect_tree_batched", spy)
    monkeypatch.setitem(tune._DEFAULTS["cpu"], "bisect_chains",
                        tune.BISECT_CHAINS_CUDA)
    got = solve()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(depths) == {8}


# ------------------------------------------------------- shapes and rules


def test_depth_rule_stays_within_one_to_eight():
    for chains in (0, 1, 3, 74000, 10**9):
        prev = 8
        for brackets in (0, 1, 2, 64, 1024, 4096, 16384, 10**5, 10**8):
            m = tune.bisect_depth(brackets, chains)
            assert 1 <= m <= 8 and m <= prev
            # the tree's node chains fit under ``chains`` unless m is 1
            assert m == 1 or max(1, brackets) * (2 ** m - 1) <= chains
            prev = m
    cuda = tune.backend_defaults("cuda")["bisect_chains"]
    assert [tune.bisect_depth(bk, cuda) for bk in (64, 1024, 4096)] == [
        8, 6, 4]
    assert tune.bisect_depth(64, tune.backend_defaults("cpu")[
        "bisect_chains"]) == 1


def test_count_launch_shape():
    # (split, threads a block): one thread a shift ...
    assert launch_shape(64, 8192, 132) == (False, 256)    # certify sweep
    assert launch_shape(1, 64, 132) == (False, 64)        # a trip
    assert launch_shape(1, 32768, 132) == (False, 256)    # certify, n=16384
    assert launch_shape(600, 130, 132) == (False, 160)    # ragged S
    assert launch_shape(1, 5, 132) == (False, 32)
    # ... but two for the Newton sweep below 128 shifts an SM
    assert launch_shape(1, 64, 132, newton=True) == (True, 128)
    assert launch_shape(64, 256, 132, newton=True) == (True, 128)
    assert launch_shape(64, 384, 132, newton=True) == (False, 256)
    assert launch_shape(1, 32768, 132, newton=True) == (False, 256)
    assert launch_shape(64, 8192, 132, newton=True) == (False, 256)
    assert launch_shape(1100, 130, 132, newton=True) == (False, 160)
    assert launch_shape(64, 8192, 132, newton=True, split=True) == (True,
                                                                     128)
    with pytest.raises(ValueError, match="only the Newton sweep"):
        launch_shape(1, 5, 132, split=True)
