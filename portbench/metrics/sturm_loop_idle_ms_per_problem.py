"""sturm_loop_idle_ms_per_problem: device idle milliseconds inside the
Sturm path's bisection loop (``repro.sturm.bisect``: the brackets, the
tree launches and each convergence check's read) per range solve."""

from pathlib import Path

from portbench import harness

SPAN = "repro.sturm.bisect"
span_tools = harness.load_reader("front_door_idle_ms_per_call",
                                 Path(__file__).resolve().parents[2])


def read(window):
    if window.trace is None or not window.problems:
        return None
    spans = span_tools.intervals(window, SPAN)
    if not spans:
        return None
    span_tools.context(window, "sturm_loop_idle_ms_per_problem", SPAN, spans)
    return span_tools.idle_inside_ns(window, spans) / 1e6 / window.problems
