"""The benchmark's arithmetic on hand-made inputs: the idle union, the
nearest-rank p95 over all calls, the window rate, kernel and host-op
attribution in a trace, the reservoir, and the frozen yardstick against
the kernel table's bounds."""

import math

import numpy as np
import pytest

from portbench import devtrace, harness, yardstick
from portbench.devtrace import DeviceTrace, Event

MS = 1_000_000  # ns


def _trace():
    """A 10 ms window: two overlapping kernels on two streams (1-4 ms and
    3-5 ms), a memcpy (6-7 ms) and a kernel that starts before the
    window; the host runs one call with an eigh op inside it."""
    device = [
        Event("void (anonymous namespace)::rows_kernel<double>(int)",
              1 * MS, 4 * MS, "kernel", corr=11),
        Event("void secular::weights_kernel<double>(int)", 3 * MS, 5 * MS,
              "kernel", corr=12),
        Event("Memcpy DtoH (Device -> Pageable)", 6 * MS, 7 * MS,
              "gpu_memcpy", corr=13),
        Event("rows_team_kernel", 9 * MS, 9 * MS + MS // 2, "kernel",
              corr=14),
    ]
    host = [
        Event("portbench.call", 0, 10 * MS, "user_annotation", 1, 7),
        Event("aten::linalg_eigh", 2 * MS, 6 * MS, "cpu_op", 11, 7),
        Event("aten::_linalg_eigh", 2 * MS, 5 * MS, "cpu_op", 13, 7),
        Event("aten::add", 8 * MS, 9 * MS, "cpu_op", 12, 7),
    ]
    host.sort(key=lambda ev: (ev.start, -ev.end))
    return DeviceTrace(0, 10 * MS, device, host)


def test_idle_is_the_complement_of_the_union_of_device_intervals():
    tr = _trace()
    # busy: [1, 5] + [6, 7] + [9, 9.5] = 5.5 ms of 10, overlap once
    assert tr.busy_intervals() == [(1 * MS, 5 * MS), (6 * MS, 7 * MS),
                                   (9 * MS, 9 * MS + MS // 2)]
    assert tr.busy_s == pytest.approx(5.5e-3)
    assert tr.window_s == pytest.approx(10e-3)
    reader = harness.load_reader("device_idle_pct")
    window = type("W", (), {"trace": tr})
    assert reader.read(window) == pytest.approx(45.0)
    # a summed-kernel reading would count the 1 ms overlap twice and the
    # memcpy not at all
    summed = sum(ev.end - ev.start for ev in tr.kernels()) / 1e9
    assert summed == pytest.approx(5.5e-3)


def test_union_clips_to_the_window_and_merges_touching_intervals():
    got = devtrace.union([(5, 9), (-3, 2), (2, 4), (8, 20)], 0, 10)
    assert got == [(0, 4), (5, 10)]
    assert devtrace.complement(got, 0, 12) == [(4, 5), (10, 12)]
    assert devtrace.union([], 0, 10) == []


def test_kernels_are_matched_by_their_whole_identifier():
    tr = _trace()
    assert tr.kernel_seconds(["rows_kernel"]) == pytest.approx(3e-3)
    assert tr.kernel_seconds(["rows_kernel", "weights_kernel"]) == \
        pytest.approx(5e-3)
    assert tr.kernel_seconds(["team_kernel"]) == 0.0
    assert len(tr.kernels()) == 3


def test_device_time_under_a_host_op_includes_its_nested_ops():
    tr = _trace()
    # corr 11 (the op itself) and 13 (nested): rows_kernel 3 ms + memcpy
    assert tr.seconds_under("aten::linalg_eigh") == pytest.approx(4e-3)
    assert tr.seconds_under("aten::mul") == 0.0


def test_idle_gaps_are_named_by_the_innermost_host_op():
    tr = _trace()
    gaps = dict(tr.idle_gaps(thread=7))
    # gaps 0-1 (call), 5-6 (linalg_eigh), 7-9 (aten::add at 8), 9.5-10
    assert gaps["portbench.call"] == pytest.approx(1.5e-3)
    assert gaps["aten::linalg_eigh"] == pytest.approx(1e-3)
    assert gaps["aten::add"] == pytest.approx(2e-3)
    assert sum(gaps.values()) == pytest.approx(4.5e-3)
    assert tr.top_device_ops(2)[0] == [
        "void (anonymous namespace)::rows_kernel<double>(int)",
        pytest.approx(3e-3)]


def test_p95_is_the_nearest_rank_over_all_calls():
    lat = list(range(1, 201))           # 200 calls
    assert harness.p95_nearest_rank(lat) == 190
    assert harness.p95_nearest_rank([5.0]) == 5.0
    assert harness.p95_nearest_rank(list(range(1, 22))) == 20  # ceil(19.95)
    with pytest.raises(ValueError):
        harness.p95_nearest_rank([])
    assert harness.rate(512, 2.0) == 256.0


def test_reservoir_keeps_a_fixed_size_uniform_sample_from_the_seed():
    counts = np.zeros(50)
    for seed in range(400):
        r = harness.Reservoir(2, seed)
        for i in range(50):
            r.offer(i, lambda i=i: i)
        assert len(r.kept) == 2 and all(r.kept[k] == k for k in r.kept)
        counts[list(r.kept)] += 1
    assert counts.sum() == 800
    assert counts.min() > 0                   # every call can be kept
    a, b = harness.Reservoir(2, 9), harness.Reservoir(2, 9)
    for i in range(30):
        a.offer(i, lambda: 0)
        b.offer(i, lambda: 0)
    assert sorted(a.kept) == sorted(b.kept)


@pytest.mark.parametrize("row, expect_ms", [(1, 0.577), (2, 0.900),
                                            (3, 0.0089), (5, 0.0151)])
def test_frozen_counts_reproduce_the_kernel_table_bounds(row, expect_ms):
    """Rows 1-3 and 5 of PERF.md's kernel table: the resident merge at
    B = 64, r = 3, K = 2048, kprime = 1536; the root solve at B = 1, K =
    kprime = 16384; the post-pass at B = 8, r = 3, K = 2048, kprime =
    1536; zhat's ratio product at B = 2, K = 8192, kprime = 7168."""
    if row == 1:
        pairs = 64 * 1536.0 ** 2
        s = yardstick.bound_s(yardstick.secular_ops(pairs)
                              + yardstick.postpass_ops(pairs, 3),
                              yardstick.resident_bytes(64, 2048, 3))
    elif row == 5:
        s = yardstick.bound_s(yardstick.zhat_ops(2 * 7168.0 ** 2), 0)
    elif row == 2:
        s = yardstick.bound_s(yardstick.secular_ops(16384.0 ** 2),
                              yardstick.secular_bytes(1, 16384))
    else:
        pairs = 8 * 1536.0 ** 2
        s = yardstick.bound_s(yardstick.postpass_ops(pairs, 3),
                              yardstick.postpass_bytes(8, 2048, 3))
    assert s * 1e3 == pytest.approx(expect_ms, rel=0.01)


def test_sturm_counts_reproduce_the_kernel_table_row_4_bounds():
    """Row 4: the count sweep at B = 64, n = 4096, S = 8192 (0.189 ms),
    the Newton sweep (0.442 ms)."""
    count = yardstick.bound_s(yardstick.sturm_ops(64, 4096, 8192, False),
                              yardstick.sturm_bytes(64, 4096, 8192, False))
    newton = yardstick.bound_s(yardstick.sturm_ops(64, 4096, 8192, True),
                               yardstick.sturm_bytes(64, 4096, 8192, True))
    assert count * 1e3 == pytest.approx(0.189, rel=0.01)
    assert newton * 1e3 == pytest.approx(0.442, rel=0.01)


def test_conquer_bound_of_a_call_reads_the_gauge_levels():
    reader = harness.load_reader("conquer_roofline")
    # two problems, n = 256, leaf 32: levels K = 64, 128, 256 (the root)
    events = [(0, 2 * 4 * 40.0, 2 * 256), (1, 2 * 2 * 100.0, 2 * 256),
              (2, 2 * 1 * 200.0, 2 * 256)]
    got = reader.call_bound_s(events, problems=2)
    want = (yardstick.conquer_level_bound_s(320.0, 8, 64, False)
            + yardstick.conquer_level_bound_s(400.0, 4, 128, False)
            + yardstick.conquer_level_bound_s(400.0, 2, 256, True))
    assert got == pytest.approx(want)
    # equal kprime on every node: (sum kprime)^2 / nodes is exact
    assert yardstick.conquer_level_bound_s(320.0, 8, 64, False) == \
        pytest.approx(yardstick.bound_s(
            yardstick.secular_ops(8 * 40.0 ** 2)
            + yardstick.postpass_ops(8 * 40.0 ** 2, 2),
            yardstick.resident_bytes(8, 64, 2)))
    assert reader.call_bound_s([], problems=1) == 0.0
    assert math.isfinite(got) and got > 0
