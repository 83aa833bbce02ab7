"""The port's eigensolver service on the card (marker ``gpu``; skipped
without one).  Imports no JAX, so it runs on the card's machine with

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_serve_card.py

  * served == sync bit for bit at B = 64 x n = 1024, float64 and
    float32, with boundary rows, every result on the card (host inputs
    of mixed n, and inputs already on the card, in the same flushes);
  * ``_flush_ready`` (the launch event's ``query()``) is false while a
    flush is in flight and true after ``event.synchronize()``;
  * the two streams overlap: a flush's demux does not wait for the next
    flush's solve;
  * results kept from early flushes are unchanged after 20 later flushes
    ran and the caller dropped theirs (the caching allocator's hazard).
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (SolveRequest, eigvalsh_tridiagonal_br,  # noqa: E402
                              execute_request, make_family)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.serve import (CoalescingScheduler,  # noqa: E402
                               EigensolverClient, ServeConfig, ServeEngine)
from repro_torch.serve.engine import _flush_ready  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


pytestmark = pytest.mark.gpu

# Cycles of torch.cuda._sleep that keep a stream busy for well over 100 ms
# at the H100's clocks (about 1.1 s at 1.755 GHz).
SLEEP_CYCLES = 2_000_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _problems(n, count, seed=0):
    fams = ("uniform", "normal", "glued_wilkinson")
    return [make_family(fams[i % len(fams)], n, seed=seed + i)
            for i in range(count)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_served_equals_sync_bitwise_on_card(cuda_device, dtype):
    probs = _problems(1024, 64, seed=5)
    reqs = [SolveRequest(d=d, e=e, return_boundary=True,
                         knobs={"dtype": dtype}) for d, e in probs]
    # Mixed n in one flush: host padding and the tracked row; inputs
    # already on the card are padded there.
    D, E = zip(*_problems(900, 4, seed=99))
    reqs.append(SolveRequest(d=np.stack(D), e=np.stack(E), kind="batch",
                             return_boundary=True, knobs={"dtype": dtype}))
    on_card = [(torch.tensor(d, device=cuda_device),
                torch.tensor(e, device=cuda_device))
               for d, e in _problems(1000, 3, seed=77)]
    reqs += [SolveRequest(d=d, e=e, return_boundary=True,
                          knobs={"dtype": dtype}) for d, e in on_card[:2]]
    reqs.append(SolveRequest(d=torch.stack([on_card[2][0]] * 2),
                             e=torch.stack([on_card[2][1]] * 2),
                             kind="batch", return_boundary=True,
                             knobs={"dtype": dtype}))
    refs = [execute_request(r) for r in reqs]
    with EigensolverClient(max_batch=64, max_wait_us=200_000) as client:
        futs = [client.submit(r) for r in reqs]
        got = [f.result(timeout=600) for f in futs]
        snap = client.metrics()["buckets"]
    for g, r in zip(got, refs):
        for name in ("eigenvalues", "blo", "bhi"):
            a, b = getattr(g, name), getattr(r, name)
            assert a.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b), name
        assert g.diagnostics == r.diagnostics
    label = f"solve/N1024/{np.dtype(dtype).name}+rows"
    assert snap[label]["coalesce_factor"] > 1.0
    assert sum(b["errors"] + b["fallbacks"] + b["retries"]
               for b in snap.values()) == 0


def _engine():
    cfg = ServeConfig(max_batch=64, max_wait_us=10_000_000)
    sched = CoalescingScheduler(cfg)
    return sched, ServeEngine(sched, cfg)


def _due_batch(sched, probs):
    futs = [sched.submit(SolveRequest(d=d, e=e)) for d, e in probs]
    with sched._cv:   # make the group due without closing intake
        for group in sched._groups.values():
            for p in group:
                p.submit_t -= 3600.0
    return futs, sched.next_flush(timeout=1.0)


def _sleep_after_execute(monkeypatch):
    """Queue SLEEP_CYCLES on the current stream after each solve, so a
    flush's launch event completes long after its launch returns."""
    real = tplan.SolvePlan.execute

    def slow(self, d, e, orig_n=None):
        out = real(self, d, e, orig_n=orig_n)
        torch.cuda._sleep(SLEEP_CYCLES)
        return out

    monkeypatch.setattr(tplan.SolvePlan, "execute", slow)


def test_flush_ready_follows_the_launch_event(cuda_device, monkeypatch):
    probs = _problems(1024, 8, seed=11)
    refs = [execute_request(SolveRequest(d=d, e=e)) for d, e in probs]
    sched, engine = _engine()
    futs, batch = _due_batch(sched, probs)
    _sleep_after_execute(monkeypatch)
    flush = engine._stage_and_launch(batch)
    assert flush.error is None and flush.ready is not None
    assert not _flush_ready(flush)          # in flight
    flush.ready.synchronize()
    assert _flush_ready(flush)
    engine._finish_safely(flush)
    for f, r in zip(futs, refs):
        assert torch.equal(f.result(timeout=0).eigenvalues, r.eigenvalues)
    sched.close()


def test_two_streams_overlap(cuda_device, monkeypatch):
    """Flush A is finished (demuxed, its futures resolved) while flush B,
    launched after it on the other stream, still runs its solve."""
    probs_a = _problems(1024, 8, seed=21)
    probs_b = _problems(1024, 8, seed=22)
    refs = [execute_request(SolveRequest(d=d, e=e)) for d, e in probs_a]
    sched, engine = _engine()
    futs_a, batch_a = _due_batch(sched, probs_a)
    flush_a = engine._stage_and_launch(batch_a)
    futs_b, batch_b = _due_batch(sched, probs_b)
    _sleep_after_execute(monkeypatch)
    flush_b = engine._stage_and_launch(batch_b)
    assert flush_a.slot.stream != flush_b.slot.stream
    t0 = time.perf_counter()
    engine._finish_safely(flush_a)
    finish_a = time.perf_counter() - t0
    assert all(f.done() for f in futs_a)
    assert not _flush_ready(flush_b), (
        f"finishing flush A ({finish_a:.3f} s) waited for flush B's solve")
    for f, r in zip(futs_a, refs):
        assert torch.equal(f.result(timeout=0).eigenvalues, r.eigenvalues)
    engine._finish_safely(flush_b)
    assert all(f.done() for f in futs_b)
    sched.close()


def test_kept_results_survive_later_flushes(cuda_device):
    """Results kept from the first flushes keep their values while 20
    later flushes run and the caller drops those results at once (after
    reading each on the default stream)."""
    kept = []
    with EigensolverClient(max_batch=8, max_wait_us=2000) as client:
        for seed in range(3):
            futs = [client.solve_async(d, e, return_boundary=True)
                    for d, e in _problems(512, 8, seed=100 + 8 * seed)]
            res = [f.result(timeout=600) for f in futs]
            kept += [(r, r.eigenvalues.clone(), r.blo.clone())
                     for r in res[::3]]
        for seed in range(20):
            futs = [client.solve_async(d, e, return_boundary=True)
                    for d, e in _problems(512, 8, seed=500 + 8 * seed)]
            for f in futs:
                r = f.result(timeout=600)
                r.eigenvalues.sum()       # a default-stream reader
            del futs, r
        assert len(client.engine.flush_log) >= 23
    torch.cuda.synchronize()
    for r, lam, blo in kept:
        assert torch.equal(r.eigenvalues, lam)
        assert torch.equal(r.blo, blo)
    for (r, _, _), (d, e) in zip(kept[:1], _problems(512, 1, seed=100)):
        ref = eigvalsh_tridiagonal_br(d, e, return_boundary=True)
        assert torch.equal(r.eigenvalues, ref.eigenvalues)
