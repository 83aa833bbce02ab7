"""Serving engine of the port (from ``repro.serve.engine``): the worker
loop that turns flush batches into launches and demuxes results back
onto request futures.

One daemon thread owns the device:

    next_flush -> stage (host pack + pad) -> launch
               -> [stage/launch the NEXT flush]  -> finish (wait + demux)

On the card every flush lives its whole life on one of two CUDA streams
the engine owns (one per buffer, alternating): the copy of its inputs,
``plan.execute``, the certify sweep, the wait, the demux, the request
finalizer and any fallback.  An event recorded after the launch stands
in for JAX's ``is_ready`` (``event.query()``) and ``block_until_ready``
(``event.synchronize()``).  Two streams, because the port's host syncs
are per stream: ``plan.execute`` returns only once its leaf's
``torch.linalg.eigh`` has run (cuSOLVER's info check), and the request
finalizer syncs for every request.  On one stream each such sync would
wait behind the next flush's whole solve, already queued there; on a
stream of its own a flush waits only for its own work.

Staging: a flush's host inputs are padded (``_host_pad``) and packed into
a pinned host buffer of the flush's stream slot, then copied with
``non_blocking=True`` on the flush's stream; a slot's buffer is rewritten
only after the event recorded behind its last copy has completed.
Inputs already on the card are padded there with ``br_dc._pad_problem``
itself, never copied to the host and back.  ``_host_pad`` is a numpy
mirror of ``_pad_problem``'s decoupled-sentinel construction (bitwise
identical; pinned by tests), so every problem's padded rows are exactly
the rows its sync solve would have produced internally and service
results stay bit-for-bit equal to the sync API.  Each problem's own
boundary row rides the tracked row slot (``SolvePlan.execute(orig_n=)``).

Results handed to callers were allocated on an engine stream: before a
future resolves, the flush's stream is synchronized (every result is
complete on the device) and each handed-out tensor is marked as used by
the device's default stream (``record_stream``), so a block a caller
frees while a default-stream kernel still reads it is not reused by a
later flush.  A caller reading results on a stream of its own must
synchronize that stream before dropping them.

Reliability comes from the ``repro_torch.runtime`` substrate: a
:class:`~repro_torch.runtime.watchdog.Watchdog` heartbeats once per
flush, a per-bucket :class:`~repro_torch.runtime.straggler.StragglerMonitor`
flags slow flushes against the bucket's own timing baseline, and
:func:`~repro_torch.runtime.retry.retry_transient` retries transient
errors.  A flush that still fails falls back to solving its requests one
by one through the sync path on the request's own device, so a poisoned
request fails alone and its flushmates complete; a kernel that fails to
build or launch fails its requests, it never turns into a CPU solve.
"""

from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import threading
import time
from concurrent.futures import InvalidStateError

import numpy as np
import torch

from repro_torch.core import br_dc as _br
from repro_torch.core import guard as _guard
from repro_torch.core import plan as _plan
from repro_torch.core import tune as _tune
from repro_torch.core.request import (SolveResult, _finalize_lanes,
                                      execute_request)
from repro_torch.runtime import StragglerMonitor, Watchdog, retry_transient
from repro_torch.runtime import faults as _faults
from repro_torch.runtime.retry import TRANSIENT_DEFAULT
from repro_torch.serve.metrics import ServeMetrics, bucket_label
from repro_torch.serve.scheduler import CoalescingScheduler, ServeConfig


def _resolve_future(future, result=None, exc=None) -> None:
    """Resolve a request future, tolerating callers that cancelled (or a
    fallback re-resolving members a partial demux already set): an
    InvalidStateError here must never escape into the worker loop -- a
    dead engine thread would hang every subsequent request forever."""
    try:
        if future.done():
            return
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except InvalidStateError:
        pass


def _host_pad(d: np.ndarray, e: np.ndarray, N: int):
    """Pad (B, n) problems to width N with decoupled sentinel blocks.

    Bitwise mirror of ``br_dc._pad_problem`` (numpy, so staging costs no
    device launches): sentinel diagonal entries sit above each problem's
    own Gershgorin bound, couplings into the padded region are exactly
    zero.  Returns (d_pad (B, N), e_pad (B, N-1)).
    """
    B, n = d.shape
    if n == N:
        return d, e
    emax = (np.max(np.abs(e), axis=1) if e.shape[1]
            else np.zeros((B,), d.dtype))
    # dtype-typed constants: NumPy 1.x value-based promotion silently
    # lifts `2.0 * f32_array` to f64.
    two = d.dtype.type(2.0)
    one = d.dtype.type(1.0)
    sentinel = np.max(np.abs(d), axis=1) + two * emax + one
    d_pad = np.concatenate(
        [d, np.broadcast_to(sentinel[:, None], (B, N - n)).astype(d.dtype)],
        axis=1)
    e_pad = np.concatenate([e, np.zeros((B, N - n), d.dtype)], axis=1)
    return d_pad, e_pad


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


def _flush_ready(flush: "_Flush") -> bool:
    """True when finishing the flush would not block: the flush already
    failed, its launch event has completed, or it has no event (a CPU
    flush, whose work is done when ``_launch`` returns)."""
    if flush.error is not None:
        return True
    return True if flush.ready is None else bool(flush.ready.query())


class _Slot:
    """One of the two stream slots of a device: the stream, its pinned
    staging buffers (by role, grown on demand) and the event recorded
    behind the last copy out of them."""
    __slots__ = ("stream", "pinned", "copied")

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device)
        self.pinned: dict = {}
        self.copied: torch.cuda.Event | None = None

    def buffer(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned (rows, cols) view for ``role``; call only after the
        slot's previous copy has completed."""
        size = int(np.prod(shape))
        buf = self.pinned.get(role)
        if buf is None or buf.dtype != dtype or buf.numel() < size:
            buf = torch.empty(max(size, 2 * (0 if buf is None
                                             else buf.numel())),
                              dtype=dtype, pin_memory=True)
            self.pinned[role] = buf
        return buf[:size].view(*shape)


class _Flush:
    """One staged flush: the launch inputs plus everything needed to
    demux device outputs back onto the member requests.  ``cert`` holds
    the flush-wide certificate mask (one batched Sturm sweep over the
    padded flush) when the route carries ``certify=True``; ``ready`` the
    event recorded after the launch on the card."""
    __slots__ = ("batch", "route", "label", "device", "slot", "result",
                 "error", "t_launch", "cert", "started", "ready",
                 "launch_t")

    def __init__(self, batch, route, label):
        self.batch = batch
        self.route = route
        self.label = label
        self.device: torch.device | None = None
        self.slot: _Slot | None = None
        self.result = None
        self.error: BaseException | None = None
        self.t_launch = 0.0
        self.cert = None
        self.started: torch.cuda.Event | None = None
        self.ready: torch.cuda.Event | None = None
        self.launch_t = (0.0, 0.0)


def _flush_device(batch) -> torch.device:
    route = batch[0].routed.route
    if route is not None:
        return torch.device(route.device)
    return _plan.resolve_device(batch[0].routed.request.device)


class ServeEngine:
    """Owns the worker thread, the watchdog, per-bucket monitors and the
    card's two stream slots.  ``flush_log`` keeps one record per finished
    flush: bucket, requests, problems, ``wall_s`` (stage to demux),
    ``launch_s`` (host time inside the launch call, staging included),
    ``launch_t`` (its perf_counter span), ``demux_s`` (the request
    finalizer per request, then the hand-out) and ``device_ms`` (the
    stream's span from the input copy to the end of the launch, CUDA
    events; None on the CPU)."""

    def __init__(self, scheduler: CoalescingScheduler,
                 config: ServeConfig | None = None,
                 metrics: ServeMetrics | None = None):
        self.scheduler = scheduler
        self.config = config or scheduler.config
        self.metrics = metrics or scheduler.metrics
        hb = self.config.heartbeat_path or os.path.join(
            tempfile.gettempdir(),
            f"repro-torch-serve-heartbeat-{os.getpid()}.json")
        self._watchdog = Watchdog(hb, timeout_s=self.config.watchdog_timeout_s)
        self._stragglers: dict[str, StragglerMonitor] = {}
        self._thread: threading.Thread | None = None
        self._flush_index = 0
        self._last_beat = 0.0
        self._beat_warned = False
        self._slots: dict[torch.device, list[_Slot]] = {}
        self._turn: dict[torch.device, int] = {}
        self.flush_log: collections.deque = collections.deque(maxlen=4096)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "ServeEngine":
        if self._thread is None:
            self._watchdog.start()
            self._thread = threading.Thread(
                target=self._loop, name="repro-torch-serve-engine",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue (the scheduler is closed first) and join."""
        self.scheduler.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._watchdog.stop()

    # --------------------------------------------------------------- loop

    def _loop(self) -> None:
        inflight: _Flush | None = None
        while True:
            if (inflight is None and self.scheduler.closed
                    and self.scheduler.pending_problems() == 0):
                return
            try:
                inflight = self._loop_once(inflight)
            except Exception as exc:
                # The worker thread must survive ANYTHING -- a dead
                # engine hangs every queued and future request forever
                # with zero errors reported.  Resolve whatever flush was
                # in flight (fallback skips already-done futures) and
                # keep serving.
                if inflight is not None:
                    for p in inflight.batch:
                        _resolve_future(p.future, exc=exc)
                    inflight = None
                else:
                    # Nothing to fail -- but never drop the evidence.
                    print(f"[serve] engine loop error (no flush in "
                          f"flight): {exc!r}", flush=True)

    def _loop_once(self, inflight: _Flush | None) -> _Flush | None:
        # Non-blocking poll while a flush is in flight (so it can be
        # finished the moment no follow-up work is due); short waits
        # otherwise to notice close/drain quickly.
        timeout = 0.0 if inflight is not None else 0.05
        batch = self.scheduler.next_flush(timeout=timeout)
        if batch is not None:
            # Flush assembly is the first point the engine owns the
            # requests: fail the ones whose deadline_ms budget ran out
            # while they were queued, so they never hold a launch slot.
            batch = self._reap_expired(batch)
        if not batch:
            if inflight is not None:
                self._finish_safely(inflight)
            else:
                self._idle_beat()
            return None
        if inflight is not None and _flush_ready(inflight):
            # Device already done: finish first so the flush's timing
            # (and its waiters' latency) don't absorb the next flush's
            # staging cost.
            self._finish_safely(inflight)
            inflight = None
        flush = self._stage_and_launch(batch)
        if inflight is not None:
            self._finish_safely(inflight)
        return flush

    def _finish_safely(self, flush: _Flush) -> None:
        """_finish with a last-resort guard: no matter what the finish
        bookkeeping does, every member future ends up resolved and the
        exception never reaches the worker loop with another flush in
        flight."""
        with self._on(flush):
            try:
                self._finish(flush)
            except Exception as exc:
                flush.error = exc
                try:
                    self._fallback(flush)
                except Exception:
                    for p in flush.batch:
                        _resolve_future(p.future, exc=exc)

    def _idle_beat(self) -> None:
        """Keep the heartbeat fresh while the service is merely idle --
        the Watchdog protocol means 'worker thread alive', not 'traffic
        present', so an external supervisor must not restart a healthy
        but quiet server."""
        now = time.monotonic()
        if now - self._last_beat >= min(30.0,
                                        self.config.watchdog_timeout_s / 4):
            self._beat(idle=True)

    def _beat(self, **info) -> None:
        self._last_beat = time.monotonic()
        try:
            self._watchdog.beat(self._flush_index, **info)
        except OSError as exc:
            # An unwritable heartbeat path degrades monitoring, never
            # serving (and must never kill the worker thread).
            if not self._beat_warned:
                self._beat_warned = True
                print(f"[serve] heartbeat write failed ({exc!r}); "
                      f"watchdog protocol degraded", flush=True)

    # ------------------------------------------------------------ streams

    def _take_slot(self, device: torch.device) -> _Slot | None:
        """The next of the device's two stream slots (None on the CPU)."""
        if device.type != "cuda":
            return None
        slots = self._slots.get(device)
        if slots is None:
            slots = self._slots[device] = [_Slot(device), _Slot(device)]
            self._turn[device] = 0
        turn = self._turn[device]
        self._turn[device] = turn ^ 1
        return slots[turn]

    @staticmethod
    def _on(flush: _Flush):
        """Make the flush's stream current (a no-op on the CPU)."""
        if flush.slot is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(flush.slot.stream)

    @staticmethod
    def _record(flush: _Flush) -> torch.cuda.Event | None:
        if flush.slot is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(flush.slot.stream)
        return ev

    @staticmethod
    def _wait(flush: _Flush) -> None:
        if flush.ready is not None:
            flush.ready.synchronize()

    # ------------------------------------------------------------- stages

    def _stage_and_launch(self, batch) -> _Flush:
        """Stage + launch one flush on its stream; returns while the
        device still computes what the host has queued.  Errors
        (including any raised at launch) are handled in _finish, whose
        relaunch path owns the transient-retry budget."""
        route = batch[0].routed.route
        flush = _Flush(batch, route, bucket_label(route))
        flush.t_launch = time.perf_counter()
        try:
            flush.device = _flush_device(batch)
            flush.slot = self._take_slot(flush.device)
            # Chaos site "serve.stage": a delay here stalls staging (the
            # straggler monitor and watchdog see it); an error demotes
            # the flush to the retry/fallback path like any staging bug.
            _faults.inject("serve.stage")
            with self._on(flush):
                flush.result = self._launch(flush)
        except Exception as exc:   # retried/isolated in _finish
            flush.error = exc
        return flush

    def _reap_expired(self, batch):
        now = time.monotonic()
        live = []
        for p in batch:
            if p.expired(now):
                self._fail_deadline(p, bucket_label(p.routed.route))
            else:
                live.append(p)
        return live

    def _fail_deadline(self, p, label: str) -> None:
        self.metrics.record_deadline(label)
        self.metrics.record_error(label)
        _guard.DEADLINES.increment()
        waited_ms = (time.monotonic() - p.submit_t) * 1e3
        _resolve_future(p.future, exc=_guard.DeadlineExceeded(
            f"request expired: deadline_ms="
            f"{p.routed.request.deadline_ms:g} budget exhausted "
            f"({waited_ms:.1f} ms since submit)"))

    def _launch_and_wait(self, flush: _Flush):
        result = self._launch(flush)
        self._wait(flush)
        return result

    def _launch(self, flush: _Flush):
        # Chaos site "serve.launch": hit once per launch *attempt*, so a
        # count-driven schedule can fail the first launch and let the
        # transient-retry relaunch succeed (or keep failing to force the
        # per-request fallback).
        _faults.inject("serve.launch")
        flush.started = self._record(flush)
        t0 = time.perf_counter()
        route = flush.route
        if isinstance(route, _plan.PlanKey):
            result = self._launch_solve(flush)
        elif isinstance(route, _plan.RangePlanKey):
            result = self._launch_range(flush)
        else:
            # Direct (uncoalescable) request: the sync path, one launch.
            result = execute_request(flush.batch[0].routed)
        flush.launch_t = (t0, time.perf_counter())
        flush.ready = self._record(flush)
        return result

    def _stage(self, flush: _Flush, width: int, pad_leaf: int | None,
               dtype: torch.dtype, extra=None):
        """The flush's stacked inputs as (d (B, width), e (B, width - 1))
        tensors on its device, members in order; ``pad_leaf`` pads each
        member to ``width`` (solve flushes).  ``extra`` is an optional
        (B,) int64 numpy vector staged alongside (``orig_n``)."""
        dev = flush.device
        members = [(p.routed.d, p.routed.e) for p in flush.batch]
        host = [not _on_card(d) for d, _ in members]
        npdtype = np.dtype(_plan._dtype_name(dtype))
        rows = [int(d.shape[0]) for d, _ in members]
        host_rows = sum(r for r, h in zip(rows, host) if h)
        slot = flush.slot
        if slot is None:
            # CPU flush: numpy staging, no copy.
            pairs = [_host_pad(_host_array(d).astype(npdtype, copy=False),
                               _host_array(e).astype(npdtype, copy=False),
                               width) for d, e in members]
            d_all = torch.from_numpy(np.ascontiguousarray(
                np.concatenate([d for d, _ in pairs], axis=0)))
            e_all = torch.from_numpy(np.ascontiguousarray(
                np.concatenate([e for _, e in pairs], axis=0)))
            ext = None if extra is None else torch.from_numpy(extra)
            return d_all, e_all, ext
        if slot.copied is not None:
            slot.copied.synchronize()   # the buffers' last copy is done
        stream = slot.stream
        d_host = e_host = None
        if host_rows:
            bd = slot.buffer("d", (host_rows, width), dtype)
            be = slot.buffer("e", (host_rows, width - 1), dtype)
            nd, ne = bd.numpy(), be.numpy()
            off = 0
            for (d, e), h, r in zip(members, host, rows):
                if not h:
                    continue
                dp, ep = _host_pad(_host_array(d).astype(npdtype, copy=False),
                                   _host_array(e).astype(npdtype, copy=False),
                                   width)
                nd[off:off + r] = dp
                ne[off:off + r] = ep
                off += r
            d_host = bd.to(dev, non_blocking=True)
            e_host = be.to(dev, non_blocking=True)
        ext = None
        if extra is not None:
            bn = slot.buffer("n", (len(extra),), torch.int64)
            bn.numpy()[:] = extra
            ext = bn.to(dev, non_blocking=True)
        slot.copied = torch.cuda.Event()
        slot.copied.record(stream)
        if all(host):
            return d_host, e_host, ext
        ds, es, off = [], [], 0
        for (d, e), h, r in zip(members, host, rows):
            if h:
                ds.append(d_host[off:off + r])
                es.append(e_host[off:off + r])
                off += r
                continue
            d = d.to(device=dev, dtype=dtype)
            e = e.to(device=dev, dtype=dtype)
            if pad_leaf is not None and d.shape[1] != width:
                # On the card: _pad_problem's own operations (its e comes
                # back N wide; the executor's input stops at N - 1).
                d, e, _, _ = _br._pad_problem(d, e, pad_leaf)
                e = e[:, : width - 1]
            ds.append(d)
            es.append(e)
        return torch.cat(ds), torch.cat(es), ext

    def _launch_solve(self, flush: _Flush):
        route = flush.route
        dtype = _plan._torch_dtype(route.dtype)
        orig_n = np.concatenate([np.full((p.routed.batch,), p.routed.n,
                                         np.int64) for p in flush.batch])
        d_all, e_all, orig = self._stage(flush, route.padded_n, route.leaf,
                                         dtype, extra=orig_n)
        plan = _plan.plan_for_route(route, d_all.shape[0])
        res = plan.execute(d_all, e_all, orig_n=orig)
        if route.certify:
            # One batched Sturm sweep certifies the WHOLE flush against
            # the padded inputs.  Equal to each member's sync
            # certificate: padding is decoupled (zero couplings, sentinel
            # rows above the Gershgorin bound) so counts at real targets
            # are unchanged, and the executor masks sentinel rows out of
            # the per-problem tolerance norm.
            from repro_torch.core import bisect as _bis
            flush.cert = _bis._certify_executor(
                d_all, e_all * e_all, res.eigenvalues.to(d_all.dtype),
                orig.to(torch.int32), float(route.refine_tol))[0]
        return res

    def _launch_range(self, flush: _Flush):
        route = flush.route
        d_all, e_all, _ = self._stage(flush, route.n, None,
                                      _plan._torch_dtype(route.dtype))
        # routed.il is a scalar window start for plain range requests and
        # a per-problem (batch,) array for kind="edges" (duplicated rows,
        # bottom-k + top-k windows); broadcast_to handles both, so edges
        # probes and ordinary sliced traffic mix freely in one flush.
        il = np.concatenate([np.broadcast_to(np.asarray(p.routed.il),
                                             (p.routed.batch,))
                             for p in flush.batch])
        k = max(p.routed.k for p in flush.batch)
        plan = _plan.range_plan_for_route(route, d_all.shape[0])
        return plan.execute(d_all, e_all, il, k)

    # ------------------------------------------------------------- finish

    def _finish(self, flush: _Flush) -> None:
        if flush.error is None:
            try:
                self._wait(flush)
            except Exception as exc:
                flush.error = exc
        if (flush.error is not None and self.config.retries > 0
                and isinstance(flush.error, TRANSIENT_DEFAULT)):
            # Transient faults surface either at launch or at the wait;
            # give the whole launch+wait the configured retry budget
            # before demoting the flush to per-request fallback.  Errors
            # outside the transient classes (ValueError etc.) skip
            # straight to fallback -- relaunching a whole coalesced batch
            # on a deterministic failure would head-of-line block every
            # other bucket for retries * backoff.
            self.metrics.record_retry(flush.label)
            relaunch = retry_transient(
                self._launch_and_wait, retries=self.config.retries - 1,
                backoff_s=self.config.retry_backoff_s,
                on_retry=lambda i, exc: self.metrics.record_retry(
                    flush.label))
            try:
                flush.result = relaunch(flush)
                flush.error = None
            except Exception as exc:
                flush.error = exc
        if flush.error is not None:
            self._fallback(flush)
            return
        t_demux = time.perf_counter()
        duration = t_demux - flush.t_launch
        try:
            self._demux(flush)
        except Exception as exc:
            flush.error = exc
            self._fallback(flush)
            return
        problems = sum(p.problems for p in flush.batch)
        t_done = time.perf_counter()
        self.flush_log.append({
            "bucket": flush.label, "requests": len(flush.batch),
            "problems": problems,
            "wall_s": t_done - flush.t_launch,
            "demux_s": t_done - t_demux,
            "launch_s": flush.launch_t[1] - flush.launch_t[0],
            "launch_t": flush.launch_t,
            "device_ms": (None if flush.started is None
                          else flush.started.elapsed_time(flush.ready))})
        self.metrics.record_flush(
            flush.label, len(flush.batch), problems, duration,
            tuned=bool(_tune.serve_knobs(flush.label, flush.device)))
        now = time.monotonic()
        for p in flush.batch:
            self.metrics.record_latency(flush.label, now - p.submit_t)
        self._flush_index += 1
        self._beat(bucket=flush.label, requests=len(flush.batch),
                   problems=problems)
        mon = self._stragglers.get(flush.label)
        if mon is None:
            mon = self._stragglers[flush.label] = StragglerMonitor(
                window=self.config.straggler_window,
                threshold=self.config.straggler_threshold)
        mon.record(self._flush_index, duration)

    def _hand_out(self, flush: _Flush, done: list) -> None:
        """Resolve demuxed (future, SolveResult) pairs: on the card, wait
        for the flush's stream (every result complete) and mark each
        handed-out tensor as used by the default stream first."""
        if flush.slot is not None and done:
            torch.cuda.current_stream(flush.device).synchronize()
            default = torch.cuda.default_stream(flush.device)
            for _, res in done:
                for t in (res.eigenvalues, res.blo, res.bhi):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(default)
        for future, res in done:
            _resolve_future(future, res)

    def _demux(self, flush: _Flush) -> None:
        # Per-request views of the flush's outputs, on its device; the
        # finalizer runs per request, as the sync path runs it.
        route = flush.route
        done = []
        if isinstance(route, _plan.PlanKey):
            res = flush.result
            lam_all, blo_all, bhi_all = res.eigenvalues, res.blo, res.bhi
            cert_all = flush.cert
            now = time.monotonic()
            off = 0
            for p in flush.batch:
                r = p.routed
                end = off + r.batch
                lam = lam_all[off:end, :r.n]
                blo = None if blo_all is None else blo_all[off:end, :r.n]
                bhi = None if bhi_all is None else bhi_all[off:end, :r.n]
                cert = None if cert_all is None else cert_all[off:end, :r.n]
                off = end
                if p.expired(now):
                    # Post-launch deadline check: the flush finished, but
                    # this member's budget ran out while it executed.
                    self._fail_deadline(p, flush.label)
                    continue
                try:
                    # Per-request degradation ladder -- the SAME
                    # finalizer the sync path runs, so a request gets one
                    # answer whether it ran alone or coalesced; demux
                    # always screens for output poison.
                    lam, blo, bhi, diag = _finalize_lanes(
                        r, lam, blo, bhi, cert=cert, check_finite=True)
                except Exception as exc:
                    # A member whose ladder is exhausted fails ALONE; its
                    # flushmates keep demuxing.
                    self.metrics.record_error(flush.label)
                    _resolve_future(p.future, exc=exc)
                    continue
                if diag and diag.get("escalations"):
                    self.metrics.record_degradation(
                        flush.label,
                        lanes=sum(ev["lanes"]
                                  for ev in diag["escalations"]))
                if r.request.kind == "full":
                    lam = lam[0]
                    blo = None if blo is None else blo[0]
                    bhi = None if bhi is None else bhi[0]
                done.append((p.future, SolveResult(
                    eigenvalues=lam, blo=blo, bhi=bhi,
                    kind=r.request.kind, method=r.request.method,
                    diagnostics=diag)))
        elif isinstance(route, _plan.RangePlanKey):
            lam_all = flush.result
            now = time.monotonic()
            off = 0
            for p in flush.batch:
                r = p.routed
                lam = lam_all[off:off + r.batch, :r.k]
                off += r.batch
                if p.expired(now):
                    self._fail_deadline(p, flush.label)
                    continue
                diag = None
                if r.scale != 1.0:
                    lam = lam * (1.0 / r.scale)
                    diag = {"equilibration_scale": r.scale}
                if r.request.certify:
                    # Bisection brackets every value with exact integer
                    # counts: certified by construction, no sweep needed
                    # (mirrors the sync range path).
                    diag = dict(diag or ())
                    diag.update(certified=int(r.batch * r.k),
                                lanes=int(r.batch * r.k))
                if r.single:
                    lam = lam[0]
                done.append((p.future, SolveResult(
                    eigenvalues=lam, kind=r.request.kind,
                    method=r.request.method, diagnostics=diag)))
        else:
            p = flush.batch[0]
            if p.expired(time.monotonic()):
                self._fail_deadline(p, flush.label)
            else:
                done.append((p.future, flush.result))
        self._hand_out(flush, done)

    def _fallback(self, flush: _Flush) -> None:
        """Flush-level failure: isolate it -- re-run each member through
        the sync path on its own device, so only genuinely poisoned
        requests fail."""
        self.metrics.record_fallback(flush.label)
        for p in flush.batch:
            if p.future.done():   # partial demux already resolved it
                continue
            if p.expired(time.monotonic()):
                self._fail_deadline(p, flush.label)
                continue
            try:
                result = execute_request(p.routed)
                self._hand_out(flush, [(p.future, result)])
                self.metrics.record_latency(flush.label,
                                            time.monotonic() - p.submit_t)
            except Exception as exc:
                self.metrics.record_error(flush.label)
                _resolve_future(p.future, exc=exc)
        self._beat(bucket=flush.label, fallback=True,
                   requests=len(flush.batch))
