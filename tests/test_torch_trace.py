"""The port's ``repro.*`` spans (``core.instrument.span``) on the CPU: the
port only, no JAX.

  * With no profiler running a solve enters no ``record_function``.
  * Under ``torch.profiler`` a batch solve of B = 2 problems at n = 256,
    leaf 32 (three merge levels) gives one ``repro.solve`` holding one
    front door, stage and leaf, a level span a level, each holding one
    merge head and one conquer, the finalize spans of the plan and of
    the request, and one ``repro.sync`` at each blocking read the sites
    predict: four at the front door, two in each head that runs the
    CPU's parallel deflation head.
  * A range solve's ``repro.sturm.bisect`` holds one ``repro.sync`` a
    convergence check of the bisection loop.
  * A request the front door rejects raises and closes every span it
    opened.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import (SolveRequest, eigvalsh_tridiagonal,  # noqa: E402
                              eigvalsh_tridiagonal_range, execute_request)
from repro_torch.core import bisect as tbis  # noqa: E402
from repro_torch.core import guard, instrument, tune  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

N, LEAF, BUDGET = 256, 32, 64     # levels K = 64, 128, 256
KNOBS = dict(leaf=LEAF, deflate_budget=BUDGET)
RANGE_N = 48      # the CPU's count loop runs a Python loop over rows


def _problems(B, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n))),
            torch.as_tensor(rng.uniform(0.1, 0.3, (B, n - 1))))


def _profiled(fn):
    """fn()'s result and its ``repro.*`` spans, (name, start, end) by
    start, outer before inner, from the profiler's raw Kineto events (as
    the benchmark reads them; the profiler's event tree is slow)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("repro.")]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(spans, outer, name=None):
    return [s for s in spans if s is not outer and outer[1] <= s[1]
            and s[2] <= outer[2] and (name is None or s[0] == name)]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_an_untraced_solve_enters_no_profiler_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    D, E = _problems(2, N, 1)
    assert eigvalsh_tridiagonal(D, E, device="cpu", **KNOBS).shape == (2, N)
    assert eigvalsh_tridiagonal_range(D[0], E[0], il=3, iu=10,
                                      device="cpu").shape == (8,)
    assert instrument.span("repro.a") is instrument.span("repro.b")


def test_a_batch_solve_nests_its_spans_under_one_solve():
    D, E = _problems(2, N, 2)
    lam, spans = _profiled(
        lambda: eigvalsh_tridiagonal(D, E, device="cpu", **KNOBS))
    assert lam.shape == (2, N)
    (solve,) = _named(spans, "repro.solve")
    assert len(_inside(spans, solve)) == len(spans) - 1
    for name in ("repro.front_door", "repro.stage", "repro.leaf"):
        assert len(_named(spans, name)) == 1, name
    (front,) = _named(spans, "repro.front_door")
    assert len(_inside(spans, front, "repro.sync")) == 4
    levels = _named(spans, "repro.level")
    assert len(levels) == 3
    syncs = 4
    for level, lv in enumerate(levels):
        (head,) = _inside(spans, lv, "repro.merge.head")
        (conquer,) = _inside(spans, lv, "repro.merge.conquer")
        assert head[2] <= conquer[1]
        # the CPU's parallel deflation head reads cmax and the post-check
        # where 0 < budget < K; else the sequential chain reads nothing
        want = 2 if BUDGET < 2 * LEAF << level else 0
        assert len(_inside(spans, head, "repro.sync")) == want
        syncs += want
    assert len(_named(spans, "repro.sync")) == syncs == 8
    # the plan's tail after the tree, then the request's ladder and unwrap
    finals = _named(spans, "repro.finalize")
    assert len(finals) == 2
    assert all(f[1] >= levels[-1][2] for f in finals)


def test_the_bisection_loop_reads_once_a_convergence_check(monkeypatch):
    steps = []
    launch = ops.bisect_tree_batched

    def counted(*args, **kw):
        steps.append(kw["steps"])
        return launch(*args, **kw)
    monkeypatch.setattr(ops, "bisect_tree_batched", counted)
    D, E = _problems(1, RANGE_N, 3)
    lam, spans = _profiled(lambda: eigvalsh_tridiagonal_range(
        D[0], E[0], il=3, iu=10, device="cpu"))
    assert lam.shape == (8,)
    (solve,) = _named(spans, "repro.solve")
    (front,) = _named(spans, "repro.front_door")
    (loop,) = _inside(spans, solve, "repro.sturm.bisect")
    (polish,) = _inside(spans, solve, "repro.sturm.polish")
    assert loop[2] <= polish[1]
    assert len(_inside(spans, front, "repro.sync")) == 4
    assert _inside(spans, polish, "repro.sync") == []
    # each check that reads true is followed by ceil(_CHECK_EVERY / depth)
    # launches; the loop ends on one that reads false
    depth = tune.bisect_depth(8, tune.backend_defaults("cpu")
                              ["bisect_chains"])
    per_check = -(-tbis._CHECK_EVERY // depth)
    assert sum(steps) < tbis.DEFAULT_MAX_BISECT
    checks = math.ceil(len(steps) / per_check) + 1
    assert len(_inside(spans, loop, "repro.sync")) == checks
    assert len(_named(spans, "repro.sync")) == 4 + checks


def test_a_rejected_request_closes_every_span_it_opened(monkeypatch):
    depth = []
    record_function = torch.profiler.record_function

    class Counted(record_function):
        def __enter__(self):
            depth.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            depth.remove(self.name)
            return super().__exit__(*exc)
    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    D, E = _problems(2, N, 4)
    bad = D.clone()
    bad[1, 7] = float("nan")

    def two_requests():
        with pytest.raises(guard.InvalidInputError) as err:
            execute_request(SolveRequest(d=bad, e=E, kind="batch",
                                         knobs=KNOBS, device="cpu"))
        assert (err.value.field, err.value.lane, err.value.index) == \
            ("d", 1, 7)
        assert depth == []
        return execute_request(SolveRequest(d=D, e=E, kind="batch",
                                            knobs=KNOBS, device="cpu"))
    res, spans = _profiled(two_requests)
    assert res.eigenvalues.shape == (2, N)
    assert depth == []
    rejected, solved = _named(spans, "repro.solve")
    assert rejected[2] <= solved[1]
    # the rejected call: the front door and its one finiteness read
    assert [s[0] for s in _inside(spans, rejected)] == [
        "repro.front_door", "repro.sync"]
    # the solved call holds every span but its own and the rejected three
    assert len(_inside(spans, solved)) == len(spans) - 4
