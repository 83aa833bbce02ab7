"""front_door_idle_ms_per_call: device idle milliseconds inside the
port's front door (``repro.front_door``: validation, the finiteness and
equilibration reads, routing and the plan lookup) per call.

Also the span arithmetic the other ``repro.*`` span readers load: a
span's intervals on the calls' thread, and the device's idle time inside
their union, so nested or repeated spans count once.
"""

import sys

from portbench import devtrace

SPAN = "repro.front_door"


def intervals(window, name: str) -> list:
    """[(start, end), ...] (ns) of the host events ``name`` on the
    thread that made the window's calls."""
    return [(ev.start, ev.end) for ev in window.trace.host
            if ev.thread == window.thread and ev.name == name]


def overlap_ns(a: list, b: list) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace) -> list:
    return devtrace.complement(trace.busy_intervals(), trace.t0, trace.t1)


def idle_inside_ns(window, spans: list) -> int:
    """Device idle time in the window inside the union of ``spans``."""
    tr = window.trace
    return overlap_ns(idle_gaps(tr), devtrace.union(spans, tr.t0, tr.t1))


def context(window, metric: str, name: str, spans: list) -> None:
    """One stderr line: the span's host wall, its count a call, and the
    share of the window's idle time inside any ``repro.*`` span."""
    tr = window.trace
    wall = sum(b - a for a, b in devtrace.union(spans, tr.t0, tr.t1))
    gaps = idle_gaps(tr)
    idle = sum(b - a for a, b in gaps)
    named = devtrace.union(
        [(ev.start, ev.end) for ev in tr.host
         if ev.thread == window.thread and ev.name.startswith("repro.")],
        tr.t0, tr.t1)
    share = 100.0 * overlap_ns(gaps, named) / idle if idle else 0.0
    print(f"[portbench] {metric}: {name} host wall {wall / 1e9:.6f} s, "
          f"{len(spans) / window.calls:.4f} a call; {share:.2f}% of the "
          f"window's idle time inside repro.* spans", file=sys.stderr)


def read(window):
    if window.trace is None or not window.problems:
        return None
    spans = intervals(window, SPAN)
    if not spans:
        return None
    context(window, "front_door_idle_ms_per_call", SPAN, spans)
    return idle_inside_ns(window, spans) / 1e6 / window.calls
