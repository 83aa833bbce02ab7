"""Per-bucket serving metrics: coalesce factor, latency percentiles,
error counts, and the plan-cache view (port copy of
``repro.serve.metrics``).

Every request is attributed to the *bucket* its route key resolves to --
the same grouping the scheduler coalesces on -- so the numbers answer
the capacity-planning questions directly: how wide are flushes per
bucket (coalesce factor), what latency do requests in that bucket see
(p50/p99 submit->demux), and is steady-state traffic hitting compiled
executables (``plan_cache`` hits/traces via
:func:`repro_torch.core.plan.plan_cache_stats`).
"""

from __future__ import annotations

import threading

from repro_torch.core.instrument import LatencyRecorder


def bucket_label(route) -> str:
    """Human-stable label for a route key (PlanKey / RangePlanKey / None).

    Uses the fields that define the plan's shape class; knob fields and
    the device are left out so dashboards stay readable -- two knob
    variants of the same shape aggregate into one line -- and a request
    gets the label the JAX package gives it.
    """
    if route is None:
        return "direct"
    if hasattr(route, "padded_n"):
        tail = "+rows" if route.return_boundary else ""
        return f"solve/N{route.padded_n}/{route.dtype}{tail}"
    return f"range/n{route.n}/k{route.k_bucket}/{route.dtype}"


class _Bucket:
    __slots__ = ("requests", "problems", "flushes", "flushed_problems",
                 "tuned_flushes", "errors", "fallbacks", "retries",
                 "degradations", "degraded_lanes", "deadline_expired",
                 "latency", "flush_time")

    def __init__(self):
        self.requests = 0          # submitted requests
        self.problems = 0          # submitted problems (a batch counts B)
        self.flushes = 0           # device launches
        self.flushed_problems = 0  # problems launched (incl. coalesced)
        self.tuned_flushes = 0     # flushes coalesced under tuned limits
        self.errors = 0            # requests whose future got an exception
        self.fallbacks = 0         # flushes that fell back to singles
        self.retries = 0           # transient-error relaunches
        self.degradations = 0      # requests escalated down the ladder
        self.degraded_lanes = 0    # eigenvalue lanes recomputed by it
        self.deadline_expired = 0  # requests failed with DeadlineExceeded
        self.latency = LatencyRecorder()     # per-request submit->demux, s
        self.flush_time = LatencyRecorder()  # per-flush wall, s


class ServeMetrics:
    """Thread-safe per-bucket aggregation; ``snapshot()`` is the wire
    format (plain dicts, milliseconds for latencies)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}

    def _bucket(self, label: str) -> _Bucket:
        with self._lock:
            b = self._buckets.get(label)
            if b is None:
                b = self._buckets[label] = _Bucket()
            return b

    def record_submit(self, label: str, problems: int = 1) -> None:
        b = self._bucket(label)
        with self._lock:
            b.requests += 1
            b.problems += problems

    def record_flush(self, label: str, requests: int, problems: int,
                     duration_s: float, tuned: bool = False) -> None:
        b = self._bucket(label)
        with self._lock:
            b.flushes += 1
            b.flushed_problems += problems
            if tuned:
                b.tuned_flushes += 1
        b.flush_time.record(duration_s)

    def record_latency(self, label: str, seconds: float) -> None:
        self._bucket(label).latency.record(seconds)

    def record_error(self, label: str, n: int = 1) -> None:
        b = self._bucket(label)
        with self._lock:
            b.errors += n

    def record_fallback(self, label: str) -> None:
        b = self._bucket(label)
        with self._lock:
            b.fallbacks += 1

    def record_retry(self, label: str) -> None:
        b = self._bucket(label)
        with self._lock:
            b.retries += 1

    def record_degradation(self, label: str, lanes: int = 1) -> None:
        b = self._bucket(label)
        with self._lock:
            b.degradations += 1
            b.degraded_lanes += lanes

    def record_deadline(self, label: str, n: int = 1) -> None:
        b = self._bucket(label)
        with self._lock:
            b.deadline_expired += n

    def snapshot(self) -> dict:
        """Per-bucket stats + the process-wide plan-cache counters.

        ``coalesce_factor`` is launched problems per device launch --
        1.0 means the scheduler never merged anything, max_batch means
        every flush was full.
        """
        from repro_torch.core.plan import plan_cache_stats
        out: dict = {"buckets": {}, "plan_cache": plan_cache_stats()}
        with self._lock:
            items = list(self._buckets.items())
        for label, b in items:
            with self._lock:
                flushes = b.flushes
                row = {
                    "requests": b.requests,
                    "problems": b.problems,
                    "flushes": flushes,
                    "tuned_flushes": b.tuned_flushes,
                    "errors": b.errors,
                    "fallbacks": b.fallbacks,
                    "retries": b.retries,
                    "degradations": b.degradations,
                    "degraded_lanes": b.degraded_lanes,
                    "deadline_expired": b.deadline_expired,
                    "coalesce_factor": (b.flushed_problems / flushes
                                        if flushes else 0.0),
                }
            row["latency_p50_ms"] = b.latency.percentile(50) * 1e3
            row["latency_p99_ms"] = b.latency.percentile(99) * 1e3
            row["flush_p50_ms"] = b.flush_time.percentile(50) * 1e3
            out["buckets"][label] = row
        return out
