"""The readers of the program's ``repro.*`` spans on hand-made traces:
device idle inside a span, spans nested or repeated, spans of another
thread, an absent span or an empty window, and the exact sync count."""

import pytest

from portbench import harness
from portbench.devtrace import DeviceTrace, Event

MS = 1_000_000  # ns
CALLER, OTHER = 7, 9
READERS = ("front_door_idle_ms_per_call", "head_idle_ms_per_level",
           "sturm_loop_idle_ms_per_problem", "syncs_per_call")


def _host(name, a, b, thread=CALLER):
    return Event(name, a * MS, b * MS, "user_annotation", 0, thread)


def _trace(host):
    """A 20 ms window: the card busy over 2-4, 6-7 and 12-16 ms."""
    device = [Event("k", 2 * MS, 4 * MS, "kernel"),
              Event("k", 3 * MS, 4 * MS, "kernel"),
              Event("Memcpy DtoH", 6 * MS, 7 * MS, "gpu_memcpy"),
              Event("k", 12 * MS, 16 * MS, "kernel")]
    host = sorted(host, key=lambda ev: (ev.start, -ev.end))
    return DeviceTrace(0, 20 * MS, device, host)


def _window(host, calls=2, problems=4):
    return type("W", (), {"trace": _trace(host), "thread": CALLER,
                          "calls": calls, "problems": problems})


def _two_calls():
    """Two calls; the first's front door spans 1-7 ms (idle 1-2, 4-6:
    3 ms), the second's 10-13 ms (idle 10-12: 2 ms).  Two heads, one
    holding a nested head and a repeat of itself; syncs: 3 and 2."""
    return [
        _host("portbench.call", 0, 9), _host("repro.solve", 0, 9),
        _host("repro.front_door", 1, 7), _host("repro.sync", 1, 2),
        _host("repro.sync", 5, 6), _host("repro.sync", 6, 7),
        _host("repro.merge.head", 7, 9),
        _host("portbench.call", 10, 20), _host("repro.solve", 10, 20),
        _host("repro.front_door", 10, 13), _host("repro.sync", 11, 12),
        _host("repro.sync", 12, 13),
        _host("repro.merge.head", 16, 19),
        _host("repro.merge.head", 17, 18),      # nested: counts once
        _host("repro.merge.head", 16, 19),      # repeated: counts once
        _host("repro.sturm.bisect", 14, 20),
    ]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_returns_nothing_without_its_span_or_problems(name):
    reader = harness.load_reader(name)
    assert reader.read(_window([_host("portbench.call", 0, 20)])) is None
    assert reader.read(_window(_two_calls(), calls=0, problems=0)) is None
    assert reader.read(type("W", (), {"trace": None, "problems": 4})) \
        is None
    assert reader.read(_window(_two_calls())) is not None


def test_idle_inside_a_span_is_the_device_idle_cut_to_the_span():
    tools = harness.load_reader("front_door_idle_ms_per_call")
    w = _window(_two_calls())
    # idle: 0-2, 4-6, 7-12, 16-20; the front doors 1-7 and 10-13
    spans = tools.intervals(w, "repro.front_door")
    assert spans == [(1 * MS, 7 * MS), (10 * MS, 13 * MS)]
    assert tools.idle_inside_ns(w, spans) == 5 * MS
    assert tools.read(w) == pytest.approx(2.5)          # 5 ms over 2 calls
    assert tools.overlap_ns([(0, 4), (6, 9)], [(2, 7), (8, 20)]) == 4
    assert tools.overlap_ns([], [(0, 1)]) == 0


def test_nested_or_repeated_spans_count_once():
    reader = harness.load_reader("head_idle_ms_per_level")
    # heads 7-9 (idle 7-9: 2 ms) and 16-19 three times (idle 16-19: 3 ms):
    # 5 ms of idle over four head spans
    assert reader.read(_window(_two_calls())) == pytest.approx(5.0 / 4)
    sturm = harness.load_reader("sturm_loop_idle_ms_per_problem")
    # 14-20 idle 16-20, over 4 problems
    assert sturm.read(_window(_two_calls())) == pytest.approx(1.0)


def test_spans_of_another_thread_are_ignored():
    other = [_host(ev.name, ev.start // MS, ev.end // MS, OTHER)
             for ev in _two_calls()]
    for name in READERS:
        reader = harness.load_reader(name)
        assert reader.read(_window(other)) is None
        assert reader.read(_window(_two_calls() + other)) == \
            reader.read(_window(_two_calls()))


def test_syncs_per_call_counts_exactly(capsys):
    reader = harness.load_reader("syncs_per_call")
    assert reader.read(_window(_two_calls())) == 2.5    # 5 syncs, 2 calls
    assert reader.read(_window(_two_calls(), calls=5)) == 1.0
    err = capsys.readouterr().err
    # host wall of the syncs 1-2, 5-7, 11-13: 5 ms; of the idle 0-2, 4-6,
    # 7-12, 16-20 (13 ms), inside repro.* spans (0-9, 10-20): 0-2, 4-6,
    # 7-9, 10-12, 16-20 (12 ms)
    assert "repro.sync host wall 0.005000 s, 2.5000 a call" in err
    assert "92.31% of the window's idle time inside repro.* spans" in err
