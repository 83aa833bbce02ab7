"""Coalescing micro-batch scheduler over the plan-cache route keys (port
copy of ``repro.serve.scheduler``).

Concurrent callers submit :class:`~repro_torch.core.request.SolveRequest`s;
the scheduler routes each one (``route_request`` -- pure, raises on
malformed input without touching anyone else), groups pending requests
by their batch-unresolved route key, and hands flush batches to the
engine when a group hits one of three triggers:

  * **max_batch**   -- the group holds a full bucket of problems,
  * **max_wait_us** -- the group's oldest request has waited long enough
                       (the latency the service is willing to trade for
                       coalescing),
  * **pressure**    -- the bounded queue is full, so waiting longer
                       cannot increase coalescing.

Two requests coalesce *iff* their route keys are equal -- the grouping
invariant ``resolve_solve_route`` guarantees (equal keys => one shared
plan for the flushed batch).  Route keys carry the device, so CPU and
card traffic never share a group.  Unroutable requests (baseline
methods, n == 1) form singleton groups flushed immediately.

Backpressure: ``submit`` blocks while ``queue_depth`` problems are
already pending (bounded queue), so a slow device propagates to callers
instead of growing the heap; ``peak_pending`` records the high-water
mark the bound was observed to hold.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

from repro_torch.core import tune as _tune
from repro_torch.core.request import (RoutedRequest, SolveRequest,
                                      execute_request, route_request)
from repro_torch.serve.metrics import ServeMetrics, bucket_label


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving layer (see README "PyTorch/CUDA port")."""
    max_batch: int = 64          # problems per flush (per group)
    max_wait_us: int = 2000      # oldest-request age that forces a flush
    queue_depth: int = 256       # bounded queue: max pending problems
    submit_timeout_s: float = 30.0   # how long submit may block when full
    retries: int = 1             # transient-device-error relaunches per
                                 # flush (0 disables; deterministic error
                                 # classes never relaunch)
    retry_backoff_s: float = 0.05
    heartbeat_path: str | None = None   # Watchdog file (None: temp dir)
    watchdog_timeout_s: float = 300.0
    straggler_window: int = 64
    straggler_threshold: float = 3.0


@dataclasses.dataclass
class PendingRequest:
    """One queued request: its route, its future, and its clocks.

    ``deadline_t`` is the absolute monotonic instant the request's
    ``deadline_ms`` budget runs out (None: no deadline).  The engine --
    not the scheduler -- enforces it, failing expired requests with
    :class:`repro_torch.core.guard.DeadlineExceeded` at flush assembly (so an
    expired request never holds a launch slot) and again at demux (so a
    slow flush cannot resolve a request past its budget).
    """
    routed: RoutedRequest
    future: Future
    submit_t: float
    deadline_t: float | None = None

    @property
    def problems(self) -> int:
        return self.routed.batch

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t


class SchedulerClosed(RuntimeError):
    pass


class QueueFull(RuntimeError):
    pass


class CoalescingScheduler:
    """Request intake + grouping; the engine drains it via ``next_flush``."""

    def __init__(self, config: ServeConfig | None = None,
                 metrics: ServeMetrics | None = None):
        self.config = config or ServeConfig()
        self.metrics = metrics or ServeMetrics()
        self._cv = threading.Condition()
        # route key (or a unique direct token) -> list[PendingRequest];
        # insertion order preserved so the oldest group flushes first.
        self._groups: dict = {}
        # route key -> (max_batch, max_wait_us): per-bucket coalescing
        # limits from the tuning cache, falling back to the config knobs.
        self._limits: dict = {}
        self._pending = 0
        self._closed = False
        self.peak_pending = 0

    def _limits_for(self, key) -> tuple[int, int]:
        """(max_batch, max_wait_us) for one route-key group.

        Tuned per-bucket values (``core.tune`` serve entries of the route
        device's cache file, keyed by the metrics bucket label) override
        the ServeConfig defaults; direct/unroutable groups always use the
        config (they flush immediately anyway).
        """
        if isinstance(key, tuple) and key and key[0] == "direct":
            return self.config.max_batch, self.config.max_wait_us
        limits = self._limits.get(key)
        if limits is None:
            tuned = _tune.serve_knobs(bucket_label(key), key.device)
            limits = (
                int(tuned.get("max_batch", self.config.max_batch)),
                int(tuned.get("max_wait_us", self.config.max_wait_us)),
            )
            self._limits[key] = limits
        return limits

    # ------------------------------------------------------------ intake

    def submit(self, request: SolveRequest) -> Future:
        """Enqueue a request; returns a Future resolving to SolveResult.

        Routing errors (bad shapes, unknown methods, malformed windows)
        fail only this request's future.  Blocks under backpressure; a
        full queue past ``submit_timeout_s`` fails the future with
        :class:`QueueFull`.
        """
        future: Future = Future()
        try:
            routed = route_request(request)
        except Exception as exc:  # poisoned request: isolate at the door
            self.metrics.record_error("rejected")
            future.set_exception(exc)
            return future

        if routed.empty:
            # A select="v" window with no eigenvalues: nothing to launch.
            future.set_result(execute_request(routed))
            return future

        label = bucket_label(routed.route)
        deadline = time.monotonic() + self.config.submit_timeout_s
        with self._cv:
            while (not self._closed
                   and self._pending + routed.batch > self.config.queue_depth
                   and self._pending > 0):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    self.metrics.record_error(label)
                    future.set_exception(QueueFull(
                        f"serve queue full ({self._pending} problems "
                        f"pending >= queue_depth={self.config.queue_depth})"))
                    return future
            if self._closed:
                future.set_exception(SchedulerClosed("scheduler is closed"))
                return future
            key = routed.route if routed.route is not None \
                else ("direct", id(future))
            now = time.monotonic()
            deadline_t = (None if request.deadline_ms is None
                          else now + request.deadline_ms * 1e-3)
            self._groups.setdefault(key, []).append(
                PendingRequest(routed, future, now, deadline_t))
            self._pending += routed.batch
            self.peak_pending = max(self.peak_pending, self._pending)
            self.metrics.record_submit(label, routed.batch)
            self._cv.notify_all()
        return future

    # ------------------------------------------------------------ drain

    def pending_problems(self) -> int:
        with self._cv:
            return self._pending

    def next_flush(self, timeout: float | None = 0.05):
        """Block until a group is due and pop its flush batch.

        Returns a non-empty list of :class:`PendingRequest` sharing one
        route key (at most ``max_batch`` problems; an oversized single
        request flushes alone), or None when the timeout expires with
        nothing due, or None immediately when closed and drained.
        """
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cv:
            while True:
                batch = self._pop_due_locked()
                if batch:
                    self._pending -= sum(p.problems for p in batch)
                    self._cv.notify_all()
                    return batch
                if self._closed and not self._groups:
                    return None
                now = time.monotonic()
                wait_until = deadline
                oldest = self._oldest_deadline_locked()
                if oldest is not None:
                    wait_until = (oldest if wait_until is None
                                  else min(wait_until, oldest))
                if wait_until is None:
                    self._cv.wait()
                    continue
                if wait_until <= now:
                    if deadline is not None and deadline <= now:
                        return None
                    continue  # a group just came due; re-evaluate
                self._cv.wait(wait_until - now)
                if (deadline is not None and time.monotonic() >= deadline
                        and not self._any_due_locked()):
                    return None

    def close(self) -> None:
        """Stop intake; queued work stays flushable (drained by the
        engine -- close makes every group immediately due)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    # ------------------------------------------------------- internals

    def _group_due_locked(self, key, group, now) -> bool:
        if not group:
            return False
        if isinstance(key, tuple) and key and key[0] == "direct":
            return True   # unroutable: nothing to coalesce with
        if self._closed:
            return True
        max_batch, max_wait_us = self._limits_for(key)
        size = sum(p.problems for p in group)
        if size >= max_batch:
            return True
        if self._pending >= self.config.queue_depth:
            return True   # pressure: waiting cannot add coalescing
        age_us = (now - group[0].submit_t) * 1e6
        return age_us >= max_wait_us

    def _any_due_locked(self) -> bool:
        now = time.monotonic()
        return any(self._group_due_locked(k, g, now)
                   for k, g in self._groups.items())

    def _oldest_deadline_locked(self):
        """Earliest moment any current group becomes due by age."""
        deadlines = [g[0].submit_t + self._limits_for(k)[1] * 1e-6
                     for k, g in self._groups.items() if g]
        return min(deadlines) if deadlines else None

    def _pop_due_locked(self):
        now = time.monotonic()
        best_key, best_size = None, -1
        for key, group in self._groups.items():
            if not self._group_due_locked(key, group, now):
                continue
            size = sum(p.problems for p in group)
            if size > best_size:
                best_key, best_size = key, size
        if best_key is None:
            return None
        group = self._groups[best_key]
        max_batch = self._limits_for(best_key)[0]
        batch, taken = [], 0
        while group:
            nxt = group[0]
            if batch and taken + nxt.problems > max_batch:
                break   # leave the remainder for the next flush
            batch.append(group.pop(0))
            taken += nxt.problems
            if taken >= max_batch:
                break
        if not group:
            del self._groups[best_key]
        return batch
