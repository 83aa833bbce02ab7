"""The port's reliability substrate (``repro_torch.runtime``: retry,
watchdog, straggler monitor) held to the JAX package's: every case of
``tests/test_runtime.py`` runs against ``repro.runtime`` and
``repro_torch.runtime``, so both packages behave alike.
"""

import json
import os
import time
import types

import pytest

import repro.runtime as j_runtime
import repro.runtime.retry as j_retry
import repro_torch.runtime as t_runtime
import repro_torch.runtime.retry as t_retry


def _namespace(pkg, retry_mod):
    return types.SimpleNamespace(
        retry_transient=pkg.retry_transient, Watchdog=pkg.Watchdog,
        StragglerMonitor=pkg.StragglerMonitor,
        TRANSIENT_DEFAULT=retry_mod.TRANSIENT_DEFAULT)


@pytest.fixture(params=["repro", "repro_torch"])
def rt(request):
    """The runtime package under test."""
    if request.param == "repro":
        return _namespace(j_runtime, j_retry)
    return _namespace(t_runtime, t_retry)


def test_port_runtime_modules_are_the_ports_own():
    assert t_runtime.retry_transient.__module__ == "repro_torch.runtime.retry"
    assert t_runtime.Watchdog.__module__ == "repro_torch.runtime.watchdog"
    assert (t_runtime.StragglerMonitor.__module__
            == "repro_torch.runtime.straggler")
    assert t_retry.TRANSIENT_DEFAULT == (OSError, RuntimeError)


# --------------------------------------------------------------- retry


def test_retry_succeeds_after_transient_failures(rt, monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("flaky interconnect")
        return "ok"

    retried = []
    out = rt.retry_transient(flaky, retries=3, backoff_s=0.1,
                          on_retry=lambda i, exc: retried.append((i, exc)))()
    assert out == "ok"
    assert calls["n"] == 3
    assert [i for i, _ in retried] == [0, 1]
    # Exponential backoff: each retry doubles the previous delay.
    assert sleeps == [0.1, 0.2]


def test_retry_budget_exhausted_raises_last_error(rt, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    calls = {"n": 0}

    def always_fails():
        calls["n"] += 1
        raise RuntimeError(f"attempt {calls['n']}")

    with pytest.raises(RuntimeError, match="attempt 3"):
        rt.retry_transient(always_fails, retries=2, backoff_s=0.0)()
    assert calls["n"] == 3          # 1 try + 2 retries, never more


def test_retry_non_transient_propagates_immediately(rt):
    calls = {"n": 0}

    def deterministic():
        calls["n"] += 1
        raise ValueError("bad input")

    with pytest.raises(ValueError):
        rt.retry_transient(deterministic, retries=5, backoff_s=0.0)()
    assert calls["n"] == 1          # ValueError is not in TRANSIENT_DEFAULT


def test_retry_custom_transient_classes(rt, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)

    class Flaky(Exception):
        pass

    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] == 1:
            raise Flaky()
        return 7

    assert rt.retry_transient(fn, retries=1, backoff_s=0.0,
                           transient=(Flaky,))() == 7
    # ...and RuntimeError is then NOT transient for this wrapper.
    with pytest.raises(RuntimeError):
        rt.retry_transient(lambda: (_ for _ in ()).throw(RuntimeError()),
                        retries=3, backoff_s=0.0, transient=(Flaky,))()


def test_transient_default_is_os_and_runtime_errors(rt):
    assert OSError in rt.TRANSIENT_DEFAULT
    assert RuntimeError in rt.TRANSIENT_DEFAULT
    assert ValueError not in rt.TRANSIENT_DEFAULT


def test_retry_passes_arguments_through(rt, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    seen = []

    def fn(a, b=0):
        seen.append((a, b))
        if len(seen) == 1:
            raise OSError()
        return a + b

    assert rt.retry_transient(fn, retries=1, backoff_s=0.0)(2, b=3) == 5
    assert seen == [(2, 3), (2, 3)]


# ------------------------------------------------------------ watchdog


def test_watchdog_beat_writes_heartbeat_file(rt, tmp_path):
    path = os.path.join(tmp_path, "sub", "hb.json")
    wd = rt.Watchdog(path, timeout_s=60.0)
    wd.beat(3, bucket="solve/N64", idle=False)
    with open(path) as f:
        payload = json.load(f)
    assert payload["step"] == 3
    assert payload["bucket"] == "solve/N64"
    assert payload["time"] == pytest.approx(time.time(), abs=60)
    # Beats replace atomically (no .tmp litter).
    assert not os.path.exists(path + ".tmp")


def test_watchdog_detects_a_hang(rt, tmp_path):
    hangs = []
    wd = rt.Watchdog(os.path.join(tmp_path, "hb.json"), timeout_s=0.05,
                  check_every_s=0.01, on_hang=lambda s: hangs.append(s))
    with wd:
        wd.beat(0)
        deadline = time.monotonic() + 5.0
        while not hangs and time.monotonic() < deadline:
            time.sleep(0.01)
    assert hangs, "watchdog never fired on a silent worker"
    assert wd.hang_count >= 1
    assert hangs[0] > 0.05


def test_watchdog_stays_quiet_while_beating(rt, tmp_path):
    hangs = []
    wd = rt.Watchdog(os.path.join(tmp_path, "hb.json"), timeout_s=0.2,
                  check_every_s=0.01, on_hang=lambda s: hangs.append(s))
    with wd:
        for step in range(10):
            wd.beat(step)
            time.sleep(0.01)
    assert not hangs
    assert wd.hang_count == 0


# ----------------------------------------------------------- straggler


def test_straggler_needs_a_baseline_first(rt):
    mon = rt.StragglerMonitor(window=16, threshold=3.0)
    for step in range(7):
        mon.record(step, 100.0)     # huge, but no baseline yet (< 8)
    assert mon.events == []


def test_straggler_flags_outlier_against_median_mad(rt):
    mon = rt.StragglerMonitor(window=64, threshold=3.0)
    for step in range(10):
        mon.record(step, 0.010 + 1e-4 * (step % 3))
    mon.record(10, 0.500)           # 50x the median
    assert len(mon.events) == 1
    ev = mon.events[0]
    assert ev["step"] == 10
    assert ev["duration"] == 0.5
    assert ev["median"] == pytest.approx(0.010, rel=0.2)
    assert ev["duration"] > ev["limit"]


def test_straggler_tolerates_normal_jitter(rt):
    mon = rt.StragglerMonitor(window=64, threshold=3.0)
    for step in range(50):
        mon.record(step, 0.010 + 1e-4 * (step % 5))
    assert mon.events == []


def test_straggler_on_straggler_hook_and_report(rt):
    fired = []
    mon = rt.StragglerMonitor(window=32, threshold=2.0,
                           on_straggler=fired.append)
    # Host 2 lags every step; hosts 0/1 anchor the overall median.
    for step in range(12):
        mon.record(step, 0.010,
                   per_host={0: 0.010, 1: 0.009, 2: 0.050})
    mon.record(12, 1.0, per_host={0: 0.010, 1: 0.009, 2: 1.0})
    assert fired and fired[0]["step"] == 12
    assert fired[0]["slow_hosts"] == [2]
    rep = mon.report()
    assert rep["events"] == 1
    assert rep["steps_tracked"] == 13
    assert rep["median_s"] == pytest.approx(0.010, rel=0.2)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # Nothing here compiles, but every test_torch_* file that imports
    # ``repro`` releases XLA:CPU's executables at its end (see
    # tests/test_torch_bisect.py): a later module on this worker must
    # not inherit memory mappings from this one.
    yield
    import jax
    jax.clear_caches()
