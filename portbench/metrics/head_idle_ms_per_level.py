"""head_idle_ms_per_level: device idle milliseconds inside the merge
head (``repro.merge.head``: z assembly, sorts, the deflation chain's
launch, compaction) per head span, i.e. per merge level of a call."""

from pathlib import Path

from portbench import harness

SPAN = "repro.merge.head"
span_tools = harness.load_reader("front_door_idle_ms_per_call",
                                 Path(__file__).resolve().parents[2])


def read(window):
    if window.trace is None or not window.problems:
        return None
    spans = span_tools.intervals(window, SPAN)
    if not spans:
        return None
    span_tools.context(window, "head_idle_ms_per_level", SPAN, spans)
    return span_tools.idle_inside_ns(window, spans) / 1e6 / len(spans)
