"""The port's eigensolver service (``repro_torch.serve``) on the CPU.

The load-bearing assertions, as in ``tests/test_serve.py`` for the JAX
package:

  * bit-for-bit -- every request kind answered by the service is
    ``torch.equal`` to the port's sync API's answer, with equal
    ``diagnostics`` (same route -> same plan -> same bits; mixed-n
    flushes ride ``_host_pad`` and the tracked-row slot);
  * the slice against ``repro`` -- the same numpy traffic through
    ``repro.serve`` and through the port agrees to the conformance bar,
    64 * eps * max(1, ||T||_inf), and boundary rows to 1e-10 up to sign
    (the bar ``tests/test_torch_solver.py`` holds rows to);
  * isolation, backpressure, coalescing, prewarm, the serve chaos cases
    of ``tests/test_chaos.py`` and the tuning cache's serve limits.

Every request says ``device="cpu"``: entry points run on the card
otherwise.  Sizes stay at n <= 100.
"""

import json
import os
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.core import request as jreq  # noqa: E402
from repro.serve import EigensolverClient as JClient  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.metrics import bucket_label as j_bucket_label  # noqa: E402
from repro_torch.core import (SOLVE_COUNTER, SolveRequest,  # noqa: E402
                              clear_plan_cache, eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br,
                              eigvalsh_tridiagonal_range, execute_request,
                              plan_cache_stats, route_request)
from repro_torch.core import br_dc as tbr  # noqa: E402
from repro_torch.core import guard as tguard  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import tune as ttune  # noqa: E402
from repro_torch.runtime import (FaultSpec, configure_faults,  # noqa: E402
                                 faults_enabled, reset_faults)
from repro_torch.serve import (CoalescingScheduler,  # noqa: E402
                               EigensolverClient, QueueFull, ServeConfig,
                               bucket_label)
from repro_torch.serve.engine import _host_pad  # noqa: E402

CPU = "cpu"
EPS = np.finfo(np.float64).eps
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def _clean_slate():
    # clear_plan_cache resets the fault registry, the robustness counters
    # and the tuning memo on both sides of every test.
    clear_plan_cache()
    yield
    clear_plan_cache()
    assert not faults_enabled()


def _problem(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.normal(size=n), rng.normal(size=n - 1)


def _problems(n, count, seed=0):
    return [_problem(n, seed=seed + 17 * i) for i in range(count)]


def _client(**kw):
    return EigensolverClient(**kw)


def _sync(d, e, **kw):
    return eigvalsh_tridiagonal(d, e, device=CPU, **kw)


def _same(got, want):
    """SolveResults equal bit for bit, diagnostics included."""
    for name in ("eigenvalues", "blo", "bhi"):
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        assert a.device == b.device and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert got.diagnostics == want.diagnostics
    assert (got.kind, got.method) == (want.kind, want.method)


def _tinf(d, e):
    row = np.abs(np.asarray(d, np.float64)).copy()
    if len(e):
        row[:-1] += np.abs(e)
        row[1:] += np.abs(e)
    return float(row.max())


# ---------------------------------------------------------------- routing


def test_route_key_equality_is_the_coalescing_invariant():
    d40, e40 = _problem(40)
    d64, e64 = _problem(64)
    r40 = route_request(SolveRequest(d=d40, e=e40, device=CPU))
    r64 = route_request(SolveRequest(d=d64, e=e64, device=CPU))
    # Same padded bucket -> same route -> coalescable...
    assert r40.route == r64.route
    assert r40.route.batch_bucket == 0  # batch axis left to the flush
    # ...while knob, shape or device changes split the route.
    r_rows = route_request(SolveRequest(d=d64, e=e64, return_boundary=True,
                                        device=CPU))
    assert r_rows.route != r64.route
    d100, e100 = _problem(100)
    assert route_request(SolveRequest(d=d100, e=e100, device=CPU)
                         ).route != r64.route
    card = r64.route._replace(device="cuda:0")
    assert card != r64.route
    assert bucket_label(card) == bucket_label(r64.route)


@pytest.mark.parametrize("kw", [
    dict(kind="full", n=40),
    dict(kind="full", n=16),                     # L == 0: rows for free
    dict(kind="full", n=64, return_boundary=True),
    dict(kind="batch", n=100, B=3),
    dict(kind="batch", n=50, B=2, knobs={"dtype": "float32"}),
    dict(kind="range", n=64, il=0, iu=5),
    dict(kind="edges", n=48, B=2, knobs={"k": 2}),
    dict(kind="full", n=40, method="sterf"),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_bucket_label_equals_repro(kw):
    kw = dict(kw)
    n, B = kw.pop("n"), kw.pop("B", None)
    d, e = _problem(n)
    if B is not None:
        d, e = np.stack([d] * B), np.stack([e] * B)
    t = route_request(SolveRequest(d=d, e=e, device=CPU, **kw))
    j = jreq.route_request(jreq.SolveRequest(d=d, e=e, **kw))
    assert bucket_label(t.route) == j_bucket_label(j.route)


def test_route_request_is_pure_wrt_plan_cache():
    d, e = _problem(48)
    route_request(SolveRequest(d=d, e=e, device=CPU))
    route_request(SolveRequest(d=d, e=e, kind="range", il=0, iu=3,
                               device=CPU))
    stats = plan_cache_stats()
    assert stats["size"] == 0 and stats["range_size"] == 0


# ------------------------------------------------------------- host pad


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 3, 40, 57, 64])
def test_host_pad_bitwise_matches_repro_and_pad_problem(n, dtype):
    """The port's ``_host_pad`` equals ``repro``'s and the port's
    ``br_dc._pad_problem`` on the same rows, bit for bit (n == N returns
    the inputs; n = 1 has no couplings)."""
    d, e = _problem(n) if n > 1 else (np.array([0.75]), np.zeros(0))
    d2 = np.stack([d, d * 0.5]).astype(dtype)
    e2 = np.stack([e, e * 2.0]).astype(dtype)
    N, _ = tbr._tree_shape(n, 32)
    dp, ep = _host_pad(d2, e2, N)
    jd, je = jengine._host_pad(d2, e2, N)
    dref, eref, N2, _ = tbr._pad_problem(torch.from_numpy(d2),
                                         torch.from_numpy(e2), 32)
    assert N2 == N and dp.shape == (2, N) and ep.shape == (2, N - 1)
    assert dp.dtype == d2.dtype and ep.dtype == d2.dtype
    assert _bits(dp) == _bits(jd) == _bits(dref)
    # _pad_problem returns e padded to length N for uniform split
    # indexing; the host form stops at the executor's N-1 input width.
    assert _bits(ep) == _bits(je) == _bits(eref[:, : N - 1])


# -------------------------------------------------------- service == sync


def test_threaded_mixed_requests_bitwise_equal_sync():
    """Threads x mixed-n/mixed-kind traffic == sequential sync results,
    bit for bit -- the acceptance criterion of the serving layer."""
    cases = []
    for n in (40, 64, 100):
        d, e = _problem(n)
        cases.append(("full", d, e, {}))
        cases.append(("range", d, e, {"il": 0, "iu": 5}))
        cases.append(("range", d, e, {"il": n - 4, "iu": n - 1}))
    db, eb = _problem(64, seed=7)
    DB = np.stack([db, 2.0 * db, db - 1.0])
    EB = np.stack([eb, eb, 0.5 * eb])
    refs = []
    for kind, d, e, kw in cases:
        if kind == "full":
            refs.append(_sync(d, e))
        else:
            refs.append(eigvalsh_tridiagonal_range(d, e, select="i",
                                                   device=CPU, **kw))
    ref_batch = eigvalsh_tridiagonal_batch(DB, EB, return_boundary=True,
                                           device=CPU)

    with _client(max_batch=8, max_wait_us=20_000) as client:
        futs = [None] * len(cases)

        def submit(lo, hi):
            for i in range(lo, hi):
                kind, d, e, kw = cases[i]
                if kind == "full":
                    futs[i] = client.solve_async(d, e, device=CPU)
                else:
                    futs[i] = client.solve_range_async(d, e, select="i",
                                                       device=CPU, **kw)
        threads = [threading.Thread(target=submit, args=(i, i + 3))
                   for i in range(0, len(cases), 3)]
        fb = client.solve_batch_async(DB, EB, return_boundary=True,
                                      device=CPU)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, ref in enumerate(refs):
            got = futs[i].result(timeout=600).eigenvalues
            assert got.device.type == "cpu"
            assert torch.equal(got, ref), f"case {i} diverged"
        res = fb.result(timeout=600)
        assert torch.equal(res.eigenvalues, ref_batch.eigenvalues)
        assert torch.equal(res.blo, ref_batch.blo)
        assert torch.equal(res.bhi, ref_batch.bhi)
        snap = client.metrics()
        assert sum(b["errors"] for b in snap["buckets"].values()) == 0


def _request_cases():
    """(id, SolveRequest kwargs) of every kind and path the service
    routes: tree solves (f64, f32, mixed, certified, rows), the Sturm
    path (range by index and by value, edges, bisect), the direct paths
    (a baseline, n == 1) and torch CPU tensors as inputs."""
    d40, e40 = _problem(40, seed=3)
    d64, e64 = _problem(64, seed=4)
    D = np.stack([d64, d64 * 0.5, d64 + 1.0])
    E = np.stack([e64, e64, e64 * 2.0])
    big = 2.0 ** 40
    return [
        ("full", dict(d=d40, e=e40)),
        ("full-f32", dict(d=d40, e=e40, knobs={"dtype": "float32"})),
        ("full-certify", dict(d=d64, e=e64, certify=True)),
        ("full-mixed", dict(d=d40, e=e40, knobs={"precision": "mixed"})),
        ("full-scaled", dict(d=d40 * big, e=e40 * big)),
        ("batch-rows", dict(d=D, e=E, kind="batch", return_boundary=True)),
        ("batch-rows-f32", dict(d=D[:, :50], e=E[:, :49], kind="batch",
                                return_boundary=True,
                                knobs={"dtype": np.float32})),
        ("range", dict(d=d64, e=e64, kind="range", il=3, iu=9)),
        ("range-certify", dict(d=d64, e=e64, kind="range", il=0, iu=3,
                               certify=True)),
        ("range-v", dict(d=d40, e=e40, kind="range", select="v",
                         vl=-1.0, vu=0.5)),
        ("edges", dict(d=D, e=E, kind="edges", knobs={"k": 2})),
        ("bisect", dict(d=d40, e=e40, method="bisect")),
        ("sterf", dict(d=d40, e=e40, method="sterf")),
        ("n1", dict(d=np.array([2.5]), e=np.zeros(0))),
        ("tensors", dict(d=torch.from_numpy(d64), e=torch.from_numpy(e64))),
    ]


def test_every_request_kind_served_bitwise_equal_sync():
    cases = _request_cases()
    refs = [execute_request(SolveRequest(device=CPU, **kw))
            for _, kw in cases]
    with _client(max_batch=16, max_wait_us=20_000) as client:
        futs = [client.submit(SolveRequest(device=CPU, **kw))
                for _, kw in cases]
        got = [f.result(timeout=600) for f in futs]
        snap = client.metrics()
    for (name, _), g, r in zip(cases, got, refs):
        try:
            _same(g, r)
        except AssertionError as exc:
            raise AssertionError(f"{name}: {exc}") from exc
    buckets = snap["buckets"]
    assert sum(b["errors"] + b["fallbacks"] + b["retries"]
               for b in buckets.values()) == 0


def test_mixed_n_flush_via_orig_n_bitwise():
    """The tracked-row mixed-size hook: host-padded problems inside one
    launch return the same boundary rows as their sync solves -- the
    n == N member too, whose sync solve tracks no third row."""
    p40, p64 = _problem(40, seed=31), _problem(64, seed=32)
    s40 = eigvalsh_tridiagonal_br(*p40, return_boundary=True, device=CPU)
    s64 = eigvalsh_tridiagonal_br(*p64, return_boundary=True, device=CPU)
    d40, e40 = _host_pad(p40[0][None], p40[1][None], 64)
    D = np.concatenate([d40, p64[0][None]], axis=0)
    E = np.concatenate([e40, p64[1][None]], axis=0)
    plan = tplan.make_plan(64, 2, return_boundary=True, device=CPU)
    res = plan.execute(D, E, orig_n=np.asarray([40, 64]))
    assert torch.equal(res.eigenvalues[0, :40], s40.eigenvalues)
    assert torch.equal(res.blo[0, :40], s40.blo)
    assert torch.equal(res.bhi[0, :40], s40.bhi)
    assert torch.equal(res.eigenvalues[1], s64.eigenvalues)
    assert torch.equal(res.blo[1], s64.blo)
    assert torch.equal(res.bhi[1], s64.bhi)


def test_mixed_n_batches_with_rows_share_a_flush_bitwise():
    reqs = []
    for i, n in enumerate((40, 57, 64)):
        d, e = _problem(n, seed=50 + i)
        reqs.append(dict(d=np.stack([d, d * 1.5]), e=np.stack([e, e]),
                         kind="batch", return_boundary=True))
    refs = [execute_request(SolveRequest(device=CPU, **kw)) for kw in reqs]
    with _client(max_batch=8, max_wait_us=200_000) as client:
        futs = [client.submit(SolveRequest(device=CPU, **kw)) for kw in reqs]
        got = [f.result(timeout=600) for f in futs]
        snap = client.metrics()
    for g, r in zip(got, refs):
        _same(g, r)
    bucket = snap["buckets"]["solve/N64/float64+rows"]
    assert bucket["flushes"] == 1 and bucket["coalesce_factor"] == 6.0


def test_served_traffic_agrees_with_repro_service():
    """The same numpy traffic through ``repro.serve`` and the port's
    service: eigenvalues within 64 eps ||T||_inf, boundary rows within
    1e-10 up to sign."""
    singles = _problems(40, 3, seed=60) + _problems(64, 2, seed=61)
    db, eb = _problem(64, seed=62)
    DB, EB = np.stack([db, db * 0.25]), np.stack([eb, eb])
    dr, er = _problem(100, seed=63)

    def run(client_cls, **dev):
        with client_cls(max_batch=8, max_wait_us=20_000) as client:
            fs = [client.solve_async(d, e, **dev) for d, e in singles]
            fb = client.solve_batch_async(DB, EB, return_boundary=True,
                                          **dev)
            fr = client.solve_range_async(dr, er, il=90, iu=99, **dev)
            return ([np.asarray(f.result(timeout=600).eigenvalues)
                     for f in fs], fb.result(timeout=600),
                    np.asarray(fr.result(timeout=600).eigenvalues))

    j_single, j_batch, j_range = run(JClient)
    t_single, t_batch, t_range = run(EigensolverClient, device=CPU)
    for (d, e), a, b in zip(singles, t_single, j_single):
        assert np.max(np.abs(a - b)) <= 64 * EPS * max(1.0, _tinf(d, e))
    for i in range(2):
        bar = 64 * EPS * max(1.0, _tinf(DB[i], EB[i]))
        assert np.max(np.abs(t_batch.eigenvalues[i].numpy()
                             - np.asarray(j_batch.eigenvalues[i]))) <= bar
        for name in ("blo", "bhi"):
            a = np.abs(getattr(t_batch, name)[i].numpy())
            b = np.abs(np.asarray(getattr(j_batch, name)[i]))
            assert np.max(np.abs(a - b)) <= 1e-10, name
    assert np.max(np.abs(t_range - j_range)) <= 64 * EPS * max(
        1.0, _tinf(dr, er))


def test_coalescing_shares_launches():
    probs = [_problem(64, seed=s) for s in range(8)]
    refs = [_sync(d, e) for d, e in probs]
    with _client(max_batch=16, max_wait_us=300_000) as client:
        with SOLVE_COUNTER.measure() as window:
            futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
            for f, ref in zip(futs, refs):
                assert torch.equal(f.result(timeout=600).eigenvalues, ref)
        snap = client.metrics()
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["coalesce_factor"] > 1.0
    assert bucket["flushes"] < bucket["requests"]
    assert window.count < 8


def test_empty_value_window_resolves_at_submit():
    d, e = _problem(32)
    lo = float(np.min(d) - np.sum(np.abs(e)) - 10.0)
    with _client() as client:
        lam = client.solve_range(d, e, select="v", vl=lo - 5.0, vu=lo,
                                 device=CPU)
    assert lam.shape == (0,)


# ------------------------------------------------------------- isolation


def test_poisoned_request_fails_alone():
    good1 = _problem(64, seed=1)
    good2 = _problem(64, seed=2)
    with _client(max_batch=8, max_wait_us=50_000) as client:
        f1 = client.solve_async(*good1, device=CPU)
        bad = client.solve_async(np.zeros(64), np.zeros(10), device=CPU)
        f_bad_method = client.submit(SolveRequest(
            d=good1[0], e=good1[1], method="nope", device=CPU))
        f2 = client.solve_async(*good2, device=CPU)
        with pytest.raises(ValueError, match="batched solve expects"):
            bad.result(timeout=600)
        with pytest.raises(ValueError, match="unknown method"):
            f_bad_method.result(timeout=600)
        assert torch.equal(f1.result(timeout=600).eigenvalues, _sync(*good1))
        assert torch.equal(f2.result(timeout=600).eigenvalues, _sync(*good2))


def test_flush_failure_falls_back_to_singles(monkeypatch):
    """A whole-flush error must demote to per-request solves (the sync
    path, on the request's device) so only the poisoned member fails."""
    real_execute = tplan.SolvePlan.execute

    def explode_on_batches(self, d, e, orig_n=None):
        if d.shape[0] > 1:
            raise RuntimeError("injected device fault")
        return real_execute(self, d, e, orig_n=orig_n)

    monkeypatch.setattr(tplan.SolvePlan, "execute", explode_on_batches)
    p1, p2 = _problem(64, seed=11), _problem(64, seed=12)
    with _client(max_batch=8, max_wait_us=100_000, retries=0) as client:
        f1 = client.solve_async(*p1, device=CPU)
        f2 = client.solve_async(*p2, device=CPU)
        r1 = f1.result(timeout=600).eigenvalues
        r2 = f2.result(timeout=600).eigenvalues
        snap = client.metrics()
    monkeypatch.undo()
    assert torch.equal(r1, _sync(*p1))
    assert torch.equal(r2, _sync(*p2))
    assert any(b["fallbacks"] >= 1 for b in snap["buckets"].values())
    assert all(b["errors"] == 0 for b in snap["buckets"].values())


def test_a_failing_solve_fails_its_requests_and_never_falls_to_success(
        monkeypatch):
    """A solve that raises on every path (the stand-in for a kernel that
    does not build) fails every member: no fallback turns it into an
    answer."""
    def broken(self, d, e, orig_n=None):
        raise RuntimeError("kernel failed to build")

    monkeypatch.setattr(tplan.SolvePlan, "execute", broken)
    with _client(max_batch=8, max_wait_us=50_000, retries=1,
                 retry_backoff_s=0.0) as client:
        futs = [client.solve_async(*_problem(64, seed=s), device=CPU)
                for s in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="failed to build"):
                f.result(timeout=600)
        snap = client.metrics()
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["errors"] == 2 and bucket["fallbacks"] >= 1


# ----------------------------------------------------------- backpressure


def _slow_result(d):
    B, n = d.shape
    return tbr.BRBatchResult(torch.zeros((B, n), dtype=d.dtype), None, None,
                             ())


def test_backpressure_bound_honored(monkeypatch):
    monkeypatch.setattr(
        tplan.SolvePlan, "execute",
        lambda self, d, e, orig_n=None: (time.sleep(0.02),
                                         _slow_result(d))[1])
    depth = 4
    with _client(max_batch=2, max_wait_us=500, queue_depth=depth) as client:
        futs = []

        def flood():
            for s in range(8):
                futs.append(client.solve_async(*_problem(64, seed=s),
                                               device=CPU))

        threads = [threading.Thread(target=flood) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=600)
        peak = client.scheduler.peak_pending
    assert peak <= depth, f"peak pending {peak} exceeded depth {depth}"


def test_queue_full_times_out_without_engine():
    cfg = ServeConfig(queue_depth=1, submit_timeout_s=0.05)
    sched = CoalescingScheduler(cfg)
    d, e = _problem(64)
    f1 = sched.submit(SolveRequest(d=d, e=e, device=CPU))
    assert isinstance(f1, Future) and not f1.done()
    f2 = sched.submit(SolveRequest(d=d, e=e, device=CPU))
    with pytest.raises(QueueFull):
        f2.result(timeout=1)
    sched.close()


def test_cancelled_future_does_not_kill_engine():
    p1, p2 = _problem(64, seed=41), _problem(64, seed=42)
    with _client(max_batch=4, max_wait_us=50_000) as client:
        f1 = client.solve_async(*p1, device=CPU)
        f1.cancel()   # queued futures are never marked running: cancellable
        f2 = client.solve_async(*p2, device=CPU)
        got = f2.result(timeout=600).eigenvalues
    assert torch.equal(got, _sync(*p2))


def test_engine_survives_heartbeat_write_failure(tmp_path):
    """An unwritable heartbeat path degrades monitoring, never serving."""
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    p1, p2 = _problem(48, seed=51), _problem(48, seed=52)
    with _client(heartbeat_path=str(blocker / "hb.json"),
                 max_wait_us=1000) as client:
        r1 = client.solve(*p1, device=CPU)
        r2 = client.solve(*p2, device=CPU)   # the worker is still alive
        assert client.engine._beat_warned
    assert torch.equal(r1, _sync(*p1))
    assert torch.equal(r2, _sync(*p2))


# ---------------------------------------------------- cache and prewarm


def test_clear_plan_cache_resets_counters():
    d, e = _problem(48, seed=21)
    _sync(d, e)
    eigvalsh_tridiagonal_range(d, e, il=0, iu=3, device=CPU)
    clear_plan_cache()
    stats = plan_cache_stats()
    assert stats["executor_traces"] == 0
    assert stats["range_executor_traces"] == 0
    assert stats["size"] == 0 and stats["range_size"] == 0
    assert stats["hits"] == stats["misses"] == 0


def test_prewarm_makes_cold_start_free():
    out = tplan.prewarm([
        {"kind": "solve", "n": 64, "batch": 4, "device": CPU},
        {"kind": "range", "n": 64, "k": 8, "batch": 1, "device": CPU}])
    assert out["plans"] == 2 and out["traces"] == 2
    assert out["seconds"] > 0.0
    t0 = plan_cache_stats()
    d, e = _problem(60, seed=23)   # same buckets: N=64, k->8
    eigvalsh_tridiagonal_batch(np.stack([d] * 3), np.stack([e] * 3),
                               device=CPU)
    eigvalsh_tridiagonal_range(np.pad(d, (0, 4)), np.pad(e, (0, 4)),
                               il=10, iu=15, device=CPU)
    t1 = plan_cache_stats()
    for key in ("executor_traces", "range_executor_traces", "misses",
                "range_misses"):
        assert t1[key] == t0[key], key


def test_prewarm_through_the_client_covers_served_flushes():
    """Prewarm every batch bucket a burst can flush at; the served
    traffic then adds no plan-cache miss."""
    spec = [{"kind": "solve", "n": 64, "batch": b, "device": CPU}
            for b in (1, 2, 4, 8)]
    spec += [{"kind": "edges", "n": 48, "k": 2, "batch": b, "device": CPU}
             for b in (1, 2, 4)]
    with _client(max_batch=8, max_wait_us=20_000, prewarm=spec) as client:
        t0 = plan_cache_stats()
        futs = [client.solve_async(*_problem(64, seed=s), device=CPU)
                for s in range(5)]
        d, e = _problem(48, seed=70)
        fe = client.submit(SolveRequest(d=np.stack([d, d]),
                                        e=np.stack([e, e]), kind="edges",
                                        knobs={"k": 2}, device=CPU))
        for f in futs + [fe]:
            f.result(timeout=600)
        t1 = plan_cache_stats()
    assert t1["misses"] == t0["misses"]
    assert t1["range_misses"] == t0["range_misses"]
    assert t1["executor_traces"] == t0["executor_traces"]


def test_prewarm_full_kind_covers_leaf_sized_requests():
    """kind='full' prewarm entries ride the same routing rules as real
    single-problem requests (incl. the L == 0 boundary-rows rule)."""
    tplan.prewarm([{"kind": "full", "n": 16, "batch": 1, "device": CPU}])
    t0 = plan_cache_stats()
    execute_request(SolveRequest(d=np.ones(16), e=np.zeros(15), device=CPU))
    t1 = plan_cache_stats()
    assert t1["executor_traces"] == t0["executor_traces"]
    assert t1["misses"] == t0["misses"]


def test_prewarm_slq_raises_what_the_request_path_raises():
    spec = [{"kind": "slq", "n": 16, "batch": 4, "leaf": 8, "device": CPU}]
    with pytest.raises(NotImplementedError, match="slq"):
        tplan.prewarm(spec)
    with pytest.raises(NotImplementedError, match="slq"):
        execute_request(SolveRequest(d=np.ones((4, 16)),
                                     e=np.zeros((4, 15)), kind="slq",
                                     device=CPU))
    with pytest.raises(NotImplementedError, match="slq"):
        EigensolverClient(prewarm=spec)
    with pytest.raises(ValueError, match="unknown prewarm kind"):
        tplan.prewarm([{"kind": "nope", "n": 16, "device": CPU}])


# ----------------------------------------------------------- serve chaos


def test_serve_flushmates_survive_a_poisoned_member():
    probs = _problems(48, 3, seed=5)
    refs = [_sync(d, e) for d, e in probs]
    clear_plan_cache()
    configure_faults([FaultSpec(site="plan.output", kind="nan", times=(0,),
                                lane=1, width=1)])
    with _client(max_wait_us=50_000) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        res = [f.result(timeout=120) for f in futs]
        snap = client.metrics()
    reset_faults()
    poisoned = [i for i, r in enumerate(res)
                if r.diagnostics and r.diagnostics.get("escalations")]
    assert len(poisoned) == 1      # exactly one member escalated...
    for i, (r, ref) in enumerate(zip(res, refs)):
        if i in poisoned:
            np.testing.assert_allclose(
                r.eigenvalues.numpy(), ref.numpy(), rtol=0,
                atol=1e-11 * float(ref.abs().max()))
        else:                      # ...and the others never noticed
            assert torch.equal(r.eigenvalues, ref)
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["degradations"] == 1
    assert bucket["degraded_lanes"] == 48
    assert bucket["fallbacks"] == 0
    assert snap["plan_cache"]["degradations"] >= 1


def test_serve_poisoned_member_escalates_as_its_sync_solve_does():
    """The served member a plan.output fault poisons gets the answer and
    diagnostics its sync solve gets under the same fault."""
    d, e = _problem(48, seed=80)
    configure_faults([FaultSpec(site="plan.output", kind="nan", times=(0,),
                                lane=0, width=1)])
    want = execute_request(SolveRequest(d=d, e=e, device=CPU))
    configure_faults([FaultSpec(site="plan.output", kind="nan", times=(0,),
                                lane=0, width=1)])
    with _client(max_wait_us=1000) as client:
        got = client.solve_async(d, e, device=CPU).result(timeout=120)
    reset_faults()
    assert want.diagnostics["escalations"]
    _same(got, want)


def test_serve_transient_launch_fault_retries_within_budget():
    probs = _problems(48, 3, seed=9)
    refs = [_sync(d, e) for d, e in probs]
    clear_plan_cache()
    configure_faults([FaultSpec(site="serve.launch", kind="error",
                                times=(0,), error="transient")])
    with _client(max_wait_us=50_000, retries=1,
                 retry_backoff_s=0.01) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        res = [f.result(timeout=120) for f in futs]
        snap = client.metrics()
    reset_faults()
    for r, ref in zip(res, refs):
        assert torch.equal(r.eigenvalues, ref)
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["retries"] == 1      # one relaunch fixed it
    assert bucket["fallbacks"] == 0
    assert bucket["errors"] == 0


def test_serve_deterministic_fault_skips_retry_falls_back():
    probs = _problems(48, 3, seed=13)
    refs = [_sync(d, e) for d, e in probs]
    clear_plan_cache()
    configure_faults([FaultSpec(site="serve.launch", kind="error",
                                times=(), error="deterministic")])
    with _client(max_wait_us=50_000, retries=3,
                 retry_backoff_s=0.01) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        res = [f.result(timeout=240) for f in futs]
        snap = client.metrics()
    reset_faults()
    for r, ref in zip(res, refs):   # fallback solves each member alone
        assert torch.equal(r.eigenvalues, ref)
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["retries"] == 0      # ValueError class: no relaunch
    assert bucket["fallbacks"] >= 1
    assert bucket["errors"] == 0       # every future still resolved OK


def test_serve_persistent_transient_fault_exhausts_budget_then_falls_back():
    probs = _problems(48, 2, seed=21)
    refs = [_sync(d, e) for d, e in probs]
    clear_plan_cache()
    configure_faults([FaultSpec(site="serve.launch", kind="error",
                                times=(), error="transient")])
    with _client(max_wait_us=50_000, retries=2,
                 retry_backoff_s=0.01) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        res = [f.result(timeout=240) for f in futs]
        snap = client.metrics()
    reset_faults()
    for r, ref in zip(res, refs):
        assert torch.equal(r.eigenvalues, ref)
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["retries"] == 2      # full budget consumed
    assert bucket["fallbacks"] >= 1    # then isolated per-request
    assert bucket["errors"] == 0


# The straggler case's margin: the injected stage delay is this many times
# the limit the bucket's monitor applies after the baseline flushes (and
# at least STRAGGLER_MIN_DELAY_S), so no host timing can hide it.
STRAGGLER_MARGIN = 10.0
STRAGGLER_MIN_DELAY_S = 0.25


def _monitor_limit(mon) -> float:
    """The limit StragglerMonitor.record applies to its next sample."""
    times = np.asarray(mon.times)
    med = float(np.median(times))
    mad = float(np.median(np.abs(times - med)))
    return med + mon.threshold * max(3 * mad, 0.1 * med)


def test_serve_stage_delay_trips_the_straggler_monitor():
    """A stage delay STRAGGLER_MARGIN times the monitor's own limit
    (measured from the baseline flushes just run) is flagged: the case
    does not depend on how fast this host solves."""
    probs = _problems(32, 11, seed=31)
    with _client(max_wait_us=100, straggler_window=16,
                 straggler_threshold=3.0) as client:
        for d, e in probs[:10]:     # closed loop: one flush per request
            client.solve(d, e, device=CPU)
        # A future resolves at demux; its flush is recorded just after.
        deadline = time.monotonic() + 30.0
        while True:
            mon = next((m for label, m in
                        list(client.engine._stragglers.items())
                        if label.startswith("solve/N32/")), None)
            if mon is not None and len(mon.times) == 10:
                break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        assert not mon.events
        delay = max(STRAGGLER_MIN_DELAY_S,
                    STRAGGLER_MARGIN * _monitor_limit(mon))
        configure_faults([FaultSpec(site="serve.stage", kind="delay",
                                    times=(0,), delay_s=delay)])
        client.solve(*probs[10], device=CPU)
    reset_faults()
    assert len(mon.events) == 1
    ev = mon.events[0]
    assert ev["duration"] >= delay > ev["limit"]


def test_deadline_expires_at_flush_assembly():
    d, e = _problem(48)
    with _client(max_wait_us=50_000) as client:
        fut = client.solve_async(d, e, deadline_ms=1e-3, device=CPU)
        with pytest.raises(tguard.DeadlineExceeded):
            fut.result(timeout=60)
        snap = client.metrics()
    bucket = snap["buckets"]["solve/N64/float64"]
    assert bucket["deadline_expired"] == 1
    assert snap["plan_cache"]["deadline_expired"] >= 1


def test_deadline_expires_post_launch_flushmates_unharmed():
    probs = _problems(48, 2, seed=41)
    ref0 = _sync(*probs[0])
    clear_plan_cache()
    # Staging stalls 0.4 s: the 50 ms-deadline member expires IN FLIGHT,
    # the unbounded member still gets its (bit-identical) answer.
    configure_faults([FaultSpec(site="serve.stage", kind="delay",
                                times=(0,), delay_s=0.4)])
    with _client(max_wait_us=50_000) as client:
        f0 = client.solve_async(*probs[0], device=CPU)
        f1 = client.solve_async(*probs[1], deadline_ms=50.0, device=CPU)
        res0 = f0.result(timeout=120)
        with pytest.raises(tguard.DeadlineExceeded):
            f1.result(timeout=120)
        snap = client.metrics()
    reset_faults()
    assert torch.equal(res0.eigenvalues, ref0)
    assert snap["buckets"]["solve/N64/float64"]["deadline_expired"] == 1


def test_every_future_resolves_under_a_hostile_schedule():
    probs = _problems(48, 8, seed=77)
    configure_faults([
        FaultSpec(site="serve.launch", kind="error", times=(0,),
                  error="transient"),
        FaultSpec(site="plan.output", kind="nan", times=(1, 3), lane=0,
                  width=2),
        FaultSpec(site="serve.stage", kind="delay", times=(2,),
                  delay_s=0.05),
    ])
    with _client(max_wait_us=200, retries=1,
                 retry_backoff_s=0.01) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        done = [f.result(timeout=240) for f in futs]
    reset_faults()
    assert len(done) == len(probs)
    for r, (d, e) in zip(done, probs):
        ref = _sync(d, e)
        np.testing.assert_allclose(r.eigenvalues.numpy(), ref.numpy(),
                                   rtol=0,
                                   atol=1e-11 * float(ref.abs().max()))


# ------------------------------------------------------------ tuning cache


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Point the tuning cache at an empty per-test dir."""
    monkeypatch.setenv(ttune.TUNE_CACHE_ENV, str(tmp_path))
    ttune.reload_tuning_cache()
    yield tmp_path
    monkeypatch.undo()
    ttune.reload_tuning_cache()


def _write_port_cache(tmp_path, entries, device=CPU):
    """A cache file in the port's format, written by hand (the writer
    comes with plan.tune)."""
    payload = {"version": ttune.TUNE_CACHE_VERSION,
               "fingerprint": ttune.fingerprint(device),
               "entries": {k: {"knobs": v, "ratio": 1.0}
                           for k, v in entries.items()}}
    path = ttune.cache_path(device)
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, "w") as f:
        json.dump(payload, f)
    ttune.reload_tuning_cache()
    return path


def test_tuned_serve_limits_apply_to_their_bucket_only(fresh_cache):
    d, e = _problem(32)
    routed = route_request(SolveRequest(d=d, e=e, device=CPU))
    label = bucket_label(routed.route)
    _write_port_cache(fresh_cache, {f"serve|{label}":
                                    {"max_batch": 2, "max_wait_us": 300}})
    sched = CoalescingScheduler(ServeConfig(max_batch=64, max_wait_us=2000))
    assert sched._limits_for(routed.route) == (2, 300)
    other = route_request(SolveRequest(d=np.ones(150), e=np.zeros(149),
                                       device=CPU))
    assert sched._limits_for(other.route) == (64, 2000)
    assert sched._limits_for(("direct", 1)) == (64, 2000)
    # The card's cache file is another file: the CPU entry is not its.
    card = routed.route._replace(device="cuda:0")
    assert sched._limits_for(card) == (64, 2000)
    sched.close()

    probs = _problems(32, 4, seed=90) + _problems(100, 4, seed=91)
    with _client(max_batch=64, max_wait_us=300_000) as client:
        futs = [client.solve_async(d, e, device=CPU) for d, e in probs]
        for f, (d, e) in zip(futs, probs):
            assert torch.equal(f.result(timeout=600).eigenvalues,
                               _sync(d, e))
        snap = client.metrics()["buckets"]
    tuned, untuned = snap[label], snap["solve/N128/float64"]
    assert tuned["flushes"] >= 2 and tuned["coalesce_factor"] <= 2.0
    assert tuned["tuned_flushes"] == tuned["flushes"]
    assert untuned["tuned_flushes"] == 0


def test_corrupt_cache_one_warning_and_default_limits(fresh_cache):
    with open(ttune.cache_path(CPU), "w") as f:
        f.write("{not json at all")
    d, e = _problem(32)
    route = route_request(SolveRequest(d=d, e=e, device=CPU)).route
    sched = CoalescingScheduler(ServeConfig(max_batch=64, max_wait_us=2000))
    with pytest.warns(RuntimeWarning, match="ignoring tuning cache") as rec:
        assert sched._limits_for(route) == (64, 2000)
    assert len([w for w in rec if issubclass(w.category,
                                             RuntimeWarning)]) == 1
    assert ttune.tuning_stats(CPU)["error"] is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # once per load, not per consult
        assert ttune.serve_knobs(bucket_label(route), CPU) == {}
        assert ttune.lookup("solve", n=64, dtype="float64",
                            device=CPU) == {}
    sched.close()


def test_repro_cache_file_is_never_read(fresh_cache):
    from repro.core import tune as jtune
    d, e = _problem(32)
    route = route_request(SolveRequest(d=d, e=e, device=CPU)).route
    label = bucket_label(route)
    jtune.reload_tuning_cache()
    jtune._save_entries({f"serve|{label}": {
        "knobs": {"max_batch": 2, "max_wait_us": 300}, "ratio": 1.0}})
    assert os.path.exists(jtune.cache_path())
    assert jtune.serve_knobs(label) == {"max_batch": 2, "max_wait_us": 300}
    assert jtune.cache_path() != ttune.cache_path(CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # a missing port file is silent
        sched = CoalescingScheduler(ServeConfig(max_batch=64,
                                                max_wait_us=2000))
        assert sched._limits_for(route) == (64, 2000)
        assert ttune.tuning_stats(CPU)["entries"] == 0
    sched.close()
    jtune.reload_tuning_cache()


def test_lookup_falls_back_from_batch_bucket_to_route_level(fresh_cache):
    _write_port_cache(fresh_cache, {
        ttune.coord_key("solve", n=64, bucket=0, dtype="float64"):
            {"chunk": 64},
        ttune.coord_key("solve", n=64, bucket=8, dtype="float64"):
            {"chunk": 32}})
    assert ttune.lookup("solve", n=64, bucket=8, dtype="float64",
                        device=CPU)["chunk"] == 32
    assert ttune.lookup("solve", n=64, bucket=2, dtype="float64",
                        device=CPU)["chunk"] == 64
    stats = ttune.tuning_stats(CPU)
    assert stats["entries"] == 2 and stats["error"] is None
    assert stats["fingerprint"]["torch"] == torch.__version__
    tplan.clear_plan_cache()     # drops the memo: the next read reloads
    os.remove(ttune.cache_path(CPU))
    assert ttune.lookup("solve", n=64, bucket=8, dtype="float64",
                        device=CPU) == {}


# ------------------------------------------------------------------ imports


def test_serve_and_runtime_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.runtime\n"
        "from repro_torch.serve import engine, client, scheduler, metrics\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles executables here; XLA:CPU keeps each
    # one's memory mappings for the life of the process, and the
    # vm.max_map_count budget is shared with the worker's later test
    # modules (see tests/test_torch_bisect.py).
    yield
    j_clear_plan_cache()
    jax.clear_caches()
