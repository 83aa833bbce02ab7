"""Lightweight instrumentation counters for the solver core (port copy).

The solver counts *device solves* (executor launches), not problems: a
batched solve of 256 tridiagonals is ONE launch.  Regression tests pin
invariants like "padded ``return_boundary`` costs exactly one solve" and
"SLQ performs one device solve for any number of probes" against these
counters, so they must be cheap, thread-safe, and easy to scope to a
code region without races between tests.

Counters also carry an opt-in **deflation-ratio gauge**: the per-level
observed secular rank fraction ``kprime / K``.  Deflation is the paper's
(and LAPACK's) dominant effective-work lever -- a glued-Wilkinson merge
that deflates 90% of its poles does 10% of the secular work -- so
benchmarks want it visible without re-running the solver.  Recording
requires a host transfer of the (tiny) per-level kprime arrays, so it is
gated: only ``measure(deflation=True)`` windows enable it, and the
steady-state solve path pays nothing.

The **refinement gauge** mirrors it for the mixed-precision pipeline:
per-solve (targets, polished, polish iterations, certify rounds) from the
f64 Sturm certification / cluster-polish stage.  The polish fraction is
the mixed path's effective-work lever exactly like the deflation ratio is
the merge tree's, and the refinement loop is host-driven anyway (its
live-set counts already cross to the host), so recording is free --
gating via ``measure(refinement=True)`` just keeps the bookkeeping out of
steady-state windows that never read it.

The **probe gauge** records spectral-monitor probe latencies (the
trainer's lam_max measurement: sliced extremal solve of the Krylov
tridiagonal, submit -> result).  Like the degradation gauge it is
ungated and bounded: probes are rare (one per governor period) and each
latency is the number the <10% monitor-overhead budget is audited
against.

**Spans** (:func:`span`) mark the solve path's layer boundaries as
``torch.profiler.record_function`` ranges named ``repro.*``, so a
running profiler writes them into its trace on the clock of the device
activity they launch: ``repro.solve`` (a request), ``repro.front_door``,
``repro.stage``, ``repro.leaf``, ``repro.level``, ``repro.merge.head``,
``repro.merge.conquer``, ``repro.sturm.bisect``, ``repro.sturm.polish``,
``repro.finalize``, and ``repro.sync`` around each blocking
device-to-host read of the front door, the deflation head, the
bisection loop's convergence check and the finalizer.  The profiler is
the switch and the exporter: with none running a span costs one C call.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a profiler range while
    a ``torch.profiler`` profile is running, and one shared no-op
    otherwise (nothing is allocated on the untraced path)."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class LatencyRecorder:
    """Thread-safe bounded sample buffer with percentile readout.

    The serving layer records one sample per request (submit -> demux)
    and per flush; ``percentile`` uses the nearest-rank convention on a
    sorted copy, so p50/p99 match what a load generator would report.
    Bounded (drops oldest beyond ``maxlen``) so a long-lived service
    never grows its metrics without bound.
    """

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._maxlen = maxlen
        self._samples: list[float] = []
        self._count = 0

    def record(self, value: float) -> None:
        with self._lock:
            self._count += 1
            self._samples.append(float(value))
            if len(self._samples) > self._maxlen:
                del self._samples[: len(self._samples) - self._maxlen]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (q in [0, 100]) of the retained
        samples; 0.0 when nothing was recorded."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
        rank = max(1, int(-(-q * len(s) // 100)))  # ceil(q/100 * N)
        return s[min(rank, len(s)) - 1]

    def snapshot(self) -> dict:
        return {"count": self.count, "p50": self.percentile(50),
                "p99": self.percentile(99)}


class CounterWindow:
    """A read-only view of a :class:`SolveCounter` since a start mark."""

    def __init__(self, counter: "SolveCounter", start: int,
                 deflation_start: int = 0, refinement_start: int = 0,
                 degradation_start: int = 0, probe_start: int = 0):
        self._counter = counter
        self._start = start
        self._deflation_start = deflation_start
        self._refinement_start = refinement_start
        self._degradation_start = degradation_start
        self._probe_start = probe_start

    @property
    def count(self) -> int:
        """Increments observed since the window opened."""
        return self._counter.count - self._start

    @property
    def deflation_ratios(self) -> dict:
        """Per-level observed deflation, aggregated over the window.

        Maps merge-tree level -> mean ``kprime / K`` across every node of
        every solve recorded since the window opened (level 0 is the
        leaf-pair merge).  Empty unless the window was opened with
        ``measure(deflation=True)`` and at least one solve ran.
        """
        events = self._counter.deflation_events(self._deflation_start)
        acc: dict[int, list] = {}
        for level, kprime_sum, total in events:
            s = acc.setdefault(level, [0.0, 0])
            s[0] += kprime_sum
            s[1] += total
        return {level: s[0] / s[1] for level, s in sorted(acc.items())
                if s[1] > 0}

    @property
    def degradation_stats(self) -> dict:
        """Graceful-degradation gauge, aggregated over the window.

        Every ladder escalation (mixed -> native, native -> bisect, ...)
        is recorded unconditionally -- escalations are rare by design and
        each one matters operationally.  Returns ``events`` (escalation
        count), ``lanes`` (total eigenvalue lanes recomputed), and
        ``by_transition`` mapping ``"from->to"`` to its event count.
        """
        events = self._counter.degradation_events(self._degradation_start)
        by: dict[str, int] = {}
        for frm, to, lanes in events:
            key = f"{frm}->{to}"
            by[key] = by.get(key, 0) + 1
        return {"events": len(events),
                "lanes": sum(e[2] for e in events),
                "by_transition": by}

    @property
    def probe_stats(self) -> dict:
        """Spectral-monitor probe gauge, aggregated over the window.

        One event per governor probe (``SpectralGovernor.probe`` /
        ``probe_tridiag``): the wall seconds of the lam_max measurement's
        eigensolve leg (direct launch or serve submit -> result).
        Returns ``probes`` (count), ``seconds`` (total), ``mean_ms`` and
        ``max_ms`` -- the numbers monitor-overhead budgets are audited
        against.
        """
        events = self._counter.probe_events(self._probe_start)
        total = sum(events)
        return {"probes": len(events), "seconds": total,
                "mean_ms": total / len(events) * 1e3 if events else 0.0,
                "max_ms": max(events, default=0.0) * 1e3}

    @property
    def refinement_stats(self) -> dict:
        """Mixed-precision refinement gauge, aggregated over the window.

        Sums the per-solve (targets, polished, iterations) of every
        mixed-precision solve recorded since the window opened, plus the
        derived ``polish_fraction`` (polished / targets) and the maximum
        certify->refine round count seen.  Empty-dict semantics match
        ``deflation_ratios``: requires ``measure(refinement=True)`` and at
        least one mixed solve; ``solves`` is 0 otherwise.
        """
        events = self._counter.refinement_events(self._refinement_start)
        targets = sum(e[0] for e in events)
        polished = sum(e[1] for e in events)
        iterations = sum(e[2] for e in events)
        return {"solves": len(events), "targets": targets,
                "polished": polished,
                "polish_fraction": polished / targets if targets else 0.0,
                "iterations": iterations,
                "max_rounds": max((e[3] for e in events), default=0)}


class SolveCounter:
    """Thread-safe monotonic event counter with scoped measurement.

    Usage (the regression-test idiom)::

        with SOLVE_COUNTER.measure() as window:
            eigvalsh_tridiagonal_br(d, e, return_boundary=True)
        assert window.count == 1

    ``measure()`` never mutates the global tally (it is a read-only view
    from a start mark), so opening a window cannot corrupt another
    window's baseline the way a ``reset()``-based idiom would.  Note the
    counter itself is process-global: a window observes increments from
    ALL threads, so exact-count assertions belong in code that owns the
    counter for the measured region (the test suite runs solves
    sequentially).  ``reset()`` exists for callers that want a hard zero.

    ``measure(deflation=True)`` additionally enables the deflation-ratio
    gauge for the window's lifetime: the solver records per-level
    ``(kprime_sum, total_poles)`` after each solve and the window exposes
    the aggregate through ``window.deflation_ratios``.
    """

    def __init__(self, name: str = "solves"):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        self._deflation: list[tuple[int, float, int]] = []
        self._deflation_depth = 0
        self._refinement: list[tuple[int, int, int, int]] = []
        self._refinement_depth = 0
        self._degradation: list[tuple[str, str, int]] = []
        self._probes: list[float] = []

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def deflation_enabled(self) -> bool:
        """True while at least one ``measure(deflation=True)`` window is
        open -- the solver checks this before paying the host transfer."""
        with self._lock:
            return self._deflation_depth > 0

    def record_deflation(self, level: int, kprime_sum: float,
                         total: int) -> None:
        """Record one level's observed secular rank: ``kprime_sum`` summed
        over the level's nodes, ``total`` the corresponding pole count."""
        with self._lock:
            self._deflation.append((int(level), float(kprime_sum),
                                    int(total)))

    def deflation_events(self, start: int = 0) -> list:
        with self._lock:
            return list(self._deflation[start:])

    @property
    def refinement_enabled(self) -> bool:
        """True while at least one ``measure(refinement=True)`` window is
        open -- the mixed-precision solve path checks this before
        recording its per-solve polish statistics."""
        with self._lock:
            return self._refinement_depth > 0

    def record_refinement(self, targets: int, polished: int,
                          iterations: int, rounds: int) -> None:
        """Record one mixed-precision solve's refinement work: ``targets``
        real eigenvalues certified, ``polished`` of them refined in f64,
        ``iterations`` total polish sweeps, over ``rounds`` certify->refine
        rounds."""
        with self._lock:
            self._refinement.append((int(targets), int(polished),
                                     int(iterations), int(rounds)))

    def refinement_events(self, start: int = 0) -> list:
        with self._lock:
            return list(self._refinement[start:])

    # Bound on retained degradation events: escalations are rare, but a
    # long-lived service under a persistent fault must not grow its
    # metrics without limit (same policy as LatencyRecorder).
    _DEGRADATION_MAXLEN = 4096

    def record_degradation(self, frm: str, to: str, lanes: int) -> None:
        """Record one graceful-degradation escalation: a solve stage
        ``frm`` handed ``lanes`` eigenvalue lanes to stage ``to``.
        Recorded unconditionally (no gate): escalations are rare and each
        one is operationally significant."""
        with self._lock:
            self._degradation.append((str(frm), str(to), int(lanes)))
            if len(self._degradation) > self._DEGRADATION_MAXLEN:
                del self._degradation[: len(self._degradation)
                                      - self._DEGRADATION_MAXLEN]

    def degradation_events(self, start: int = 0) -> list:
        with self._lock:
            return list(self._degradation[start:])

    # Bound on retained probe latencies: one event per governor period,
    # so 4096 covers hours of monitoring; a long-lived trainer must not
    # grow its metrics without limit (same policy as LatencyRecorder).
    _PROBE_MAXLEN = 4096

    def record_probe(self, seconds: float) -> None:
        """Record one spectral-monitor probe latency (the lam_max
        measurement's eigensolve leg, in wall seconds).  Recorded
        unconditionally: probes are rare and each one is the unit the
        monitor-overhead budget is stated in."""
        with self._lock:
            self._probes.append(float(seconds))
            if len(self._probes) > self._PROBE_MAXLEN:
                del self._probes[: len(self._probes) - self._PROBE_MAXLEN]

    def probe_events(self, start: int = 0) -> list:
        with self._lock:
            return list(self._probes[start:])

    def clear_degradation(self) -> None:
        """Drop recorded escalations (``clear_plan_cache`` calls this so
        chaos tests cannot leak ladder events into neighboring tests).
        The trimming in record_degradation can shift event indices under
        an open window; windows opened across a clear are void anyway."""
        with self._lock:
            self._degradation.clear()

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._deflation.clear()
            self._refinement.clear()
            self._degradation.clear()
            self._probes.clear()

    @contextlib.contextmanager
    def measure(self, deflation: bool = False, refinement: bool = False):
        """Context manager yielding a window counting from entry.

        Args:
          deflation: also enable the deflation-ratio gauge while the
            window is open (costs one tiny host transfer per solve).
          refinement: also enable the mixed-precision refinement gauge
            (free -- the refinement loop is host-driven already).
        """
        with self._lock:
            start = self._count
            dstart = len(self._deflation)
            rstart = len(self._refinement)
            gstart = len(self._degradation)
            pstart = len(self._probes)
            if deflation:
                self._deflation_depth += 1
            if refinement:
                self._refinement_depth += 1
        try:
            yield CounterWindow(self, start, dstart, rstart, gstart, pstart)
        finally:
            if deflation or refinement:
                with self._lock:
                    if deflation:
                        self._deflation_depth -= 1
                    if refinement:
                        self._refinement_depth -= 1

    def __int__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return f"SolveCounter({self.name}={self.count})"
