"""syncs_per_call: blocking device-to-host reads of the port's solve
path (``repro.sync`` spans: the front door's finiteness and
equilibration reads, the bisection loop's convergence checks, the
deflation head's and the finalizer's reads) per call; an exact count."""

from pathlib import Path

from portbench import harness

SPAN = "repro.sync"
span_tools = harness.load_reader("front_door_idle_ms_per_call",
                                 Path(__file__).resolve().parents[2])


def read(window):
    if window.trace is None or not window.problems:
        return None
    spans = span_tools.intervals(window, SPAN)
    if not spans:
        return None
    span_tools.context(window, "syncs_per_call", SPAN, spans)
    return len(spans) / window.calls
