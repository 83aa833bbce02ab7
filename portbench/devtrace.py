"""Reduction of a torch.profiler trace of the measured window to what the
per-layer metrics read: device intervals, kernels by name, device time
under a host op, and the device's idle gaps by what the host was doing.

The device is busy where any kernel, memcpy or memset runs: the union of
their intervals, so that work on two streams at once counts once and
copies count at all (``chip_smoke.py``'s ``_profile`` summed kernel times
instead).  Events come from the profiler's raw Kineto results, which
need none of the profiler's own (slow) event tree.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Event:
    """One trace event.  ``corr`` is a host op's own id, or for device
    activity the id of the host op it was launched under; ``thread`` is
    the Kineto thread of a host event."""
    name: str
    start: int          # ns, the profiler's clock (Unix epoch)
    end: int
    kind: str           # Kineto activity type
    corr: int = 0
    thread: int = 0


@dataclasses.dataclass
class DeviceTrace:
    """The events of one traced window [t0, t1] (ns)."""
    t0: int
    t1: int
    device: list        # device activity, sorted by start
    host: list          # host ops and annotations, sorted by start

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def kernels(self) -> list:
        return [ev for ev in self.device if ev.kind == "kernel"]

    def busy_intervals(self) -> list:
        return union([(ev.start, ev.end) for ev in self.device],
                     self.t0, self.t1)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose identifier is one of
        ``names`` (matched whole in the demangled name)."""
        pattern = identifier_pattern(names)
        by_name: dict = {}
        for ev in self.kernels():
            by_name[ev.name] = by_name.get(ev.name, 0) + (ev.end - ev.start)
        return sum(ns for name, ns in by_name.items()
                   if pattern.search(name)) / 1e9

    def seconds_under(self, op_name: str) -> float:
        """Device seconds of the activity launched under the host op
        ``op_name`` or any op nested in it."""
        spans = sorted((ev.start, ev.end, ev.thread) for ev in self.host
                       if ev.name == op_name and ev.kind == "cpu_op")
        if not spans:
            return 0.0
        starts = [ev.start for ev in self.host]
        inside = set()
        for a, b, thread in spans:
            i = bisect.bisect_left(starts, a)
            while i < len(self.host) and self.host[i].start <= b:
                ev = self.host[i]
                if (ev.thread == thread and ev.end <= b
                        and ev.kind == "cpu_op"):
                    inside.add(ev.corr)
                i += 1
        return sum(ev.end - ev.start for ev in self.device
                   if ev.corr in inside) / 1e9

    def counts(self) -> dict:
        """Events by Kineto activity type, device and host."""
        out: dict = {}
        for ev in self.device + self.host:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def top_device_ops(self, count: int = 10) -> list:
        """[[kernel or copy name, seconds], ...], the largest first."""
        acc: dict = {}
        for ev in self.device:
            acc[ev.name] = acc.get(ev.name, 0) + (ev.end - ev.start)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, thread: int, count: int = 10) -> list:
        """The device's idle time in the window, by the innermost host op
        or annotation on ``thread`` that was running at each gap's middle
        ("host" where none was): [[name, seconds], ...], largest first."""
        gaps = complement(self.busy_intervals(), self.t0, self.t1)
        events = [ev for ev in self.host if ev.thread == thread]
        acc: dict = {}
        stack: list = []
        i = 0
        for a, b in gaps:
            mid = (a + b) // 2
            while i < len(events) and events[i].start <= mid:
                while stack and stack[-1].end < events[i].start:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            name = stack[-1].name if stack else "host"
            acc[name] = acc.get(name, 0) + (b - a)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns / 1e9] for name, ns in top]


def identifier_pattern(names) -> re.Pattern:
    """A demangled kernel name such as ``void (anonymous
    namespace)::rows_kernel<double>(...)`` holds its identifier whole."""
    alt = "|".join(re.escape(n) for n in names)
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alt})(?![A-Za-z0-9_])")


def union(intervals, lo: int, hi: int) -> list:
    """The union of [a, b) intervals, clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def complement(busy, lo: int, hi: int) -> list:
    """The gaps of [lo, hi] that sorted disjoint ``busy`` leaves."""
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def _kind(kev, cuda_type) -> str:
    """The Kineto activity type of a raw event.  PyTorch builds that do
    not expose it (2.11) get it from the device, the name and the user
    annotation flag: device events are kernels, memcpys or memsets (a
    runtime call's name or an annotation mirrored onto the device is
    neither), host events ops, annotations or runtime calls."""
    activity = getattr(kev, "activity_type", None)
    if activity is not None:
        return activity()
    name = kev.name()
    annotation = (kev.is_user_annotation() if hasattr(
        kev, "is_user_annotation") else name.startswith("portbench."))
    if kev.device_type() == cuda_type:
        if annotation or name.startswith("portbench."):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if name.startswith("cuda"):
            return "cuda_sync"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def from_profiler(prof, t0: int, t1: int) -> DeviceTrace:
    """The window [t0, t1] (ns, ``time.time_ns()``) of a finished
    ``torch.profiler.profile``'s raw Kineto results: the device activity
    that starts in it and the host events that overlap it."""
    from torch.autograd import DeviceType
    device, host = [], []
    for kev in prof.profiler.kineto_results.events():
        start = kev.start_ns()
        end = start + kev.duration_ns()
        if end < t0 or start > t1:
            continue
        kind = _kind(kev, DeviceType.CUDA)
        if kev.device_type() == DeviceType.CUDA:
            if kind in DEVICE_ACTIVITIES and start >= t0:
                device.append(Event(kev.name(), start, end, kind,
                                    kev.linked_correlation_id()))
        elif kind in ("cpu_op", "user_annotation", "cuda_runtime",
                      "cuda_driver"):
            host.append(Event(kev.name(), start, end, kind,
                              kev.correlation_id(), kev.start_thread_id()))
    device.sort(key=lambda ev: ev.start)
    host.sort(key=lambda ev: (ev.start, -ev.end))
    return DeviceTrace(t0, t1, device, host)
