"""The port's tuning writer and route-time consult (``repro_torch.core.tune``
and ``repro_torch.core.plan``) on the CPU, held to the JAX package.

  * The consult: the same seeded entries in both packages' cache files
    (``tests/test_tune.py``'s cases) resolve to route keys with equal knob
    fields -- leaf, thresholds, budgets, range maxiter and polish, the
    batch-bucket chunk and its fallback to the route-level entry -- and
    equal provenance counts; explicit knobs always win.
  * The round trip: ``plan.tune`` on a tiny workload writes a file of the
    reader's version and fingerprint whose entries never lose to the
    defaults (ratio >= 1); a fresh consult resolves the winners, and a
    tuned and an explicit request resolve to the same key and give the
    same bits (``torch.equal``).  The JAX package's own round trip is not
    run here (it takes minutes on the CPU).
  * The defaults table and the per-device-type candidate grids.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import tune as jtune  # noqa: E402
from repro_torch.core import bisect as tbis  # noqa: E402
from repro_torch.core import eigvalsh_tridiagonal_batch  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import tune as ttune  # noqa: E402
from repro_torch.core.request import SolveRequest, route_request  # noqa: E402
from repro_torch.serve import (CoalescingScheduler, ServeConfig,  # noqa: E402
                               bucket_label)

CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

# The knob fields of a full-spectrum route key the consult decides.
SOLVE_FIELDS = ("padded_n", "leaf", "batch_bucket", "dtype", "chunk",
                "niter", "stream_threshold", "deflate_budget",
                "resident_threshold", "precision")


from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    jplan.clear_plan_cache()
    jax.clear_caches()


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Both packages' caches in an empty per-test directory (they never
    share a file name), every memo and counter reset."""
    monkeypatch.setenv(ttune.TUNE_CACHE_ENV, str(tmp_path))
    assert jtune.TUNE_CACHE_ENV == ttune.TUNE_CACHE_ENV
    for plan in (jplan, tplan):
        plan.clear_plan_cache()
    yield tmp_path
    monkeypatch.undo()
    for plan in (jplan, tplan):
        plan.clear_plan_cache()


def _seed(entries):
    """The same entries in both packages' cache files."""
    payload = {coord: {"knobs": knobs, "ratio": 1.0}
               for coord, knobs in entries.items()}
    jtune._save_entries(payload)
    ttune._save_entries(payload, CPU)
    assert jtune.cache_path() != ttune.cache_path(CPU)


def _fields(key, names=SOLVE_FIELDS):
    return {f: getattr(key, f) for f in names}


def _problem(n, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n)), rng.standard_normal((B, n - 1))


# ------------------------------------------------------------ the consult


@pytest.mark.parametrize("precision", ["native", "mixed"])
def test_none_knobs_consult_and_explicit_wins(fresh_cache, precision):
    _seed({ttune.coord_key("solve", n=64, bucket=0, dtype="float64",
                           precision=precision):
           {"leaf": 16, "stream_threshold": 48, "deflate_budget": 24,
            "resident_threshold": 96}})
    kw = {"precision": precision}
    got = tplan.resolve_solve_route(64, device=CPU, **kw)
    want = jplan.resolve_solve_route(64, mesh=None, **kw)
    assert _fields(got) == _fields(want)
    assert (got.leaf, got.stream_threshold, got.deflate_budget,
            got.resident_threshold) == (16, 48, 24, 96)
    # The request path's single-leaf check resolves the same leaf.
    assert tplan.resolve_leaf(None, 64, "float64", precision, CPU) == 16
    # Explicit knobs always beat the cache.
    got = tplan.resolve_solve_route(64, leaf=32, stream_threshold=0,
                                    device=CPU, **kw)
    want = jplan.resolve_solve_route(64, leaf=32, stream_threshold=0,
                                     mesh=None, **kw)
    assert _fields(got) == _fields(want)
    assert (got.leaf, got.stream_threshold) == (32, 0)
    # Another precision's coordinate is untuned: the defaults.
    other = "native" if precision == "mixed" else "mixed"
    got = tplan.resolve_solve_route(64, precision=other, device=CPU)
    want = jplan.resolve_solve_route(64, precision=other, mesh=None)
    assert _fields(got) == _fields(want)
    assert got.leaf == tplan.LEAF_DEFAULT


def test_batch_bucket_chunk_and_its_fallback(fresh_cache):
    _seed({ttune.coord_key("solve", n=64, bucket=0, dtype="float64"):
           {"chunk": 64},
           ttune.coord_key("solve", n=64, bucket=8, dtype="float64"):
           {"chunk": 32}})
    for bucket, chunk in ((8, 32), (2, 64)):
        assert ttune.lookup("solve", n=64, bucket=bucket, dtype="float64",
                            device=CPU) == jtune.lookup(
            "solve", n=64, bucket=bucket, dtype="float64") == \
            {"chunk": chunk}
    for batch in (5, 8, 2):
        got = tplan.make_plan(64, batch, device=CPU).key
        want = jplan.make_plan(64, batch, mesh=None).key
        assert _fields(got) == _fields(want), batch
    assert tplan.make_plan(64, 8, device=CPU).key.chunk == 32
    # The tuned chunk never exceeds the requested one.
    assert tplan.make_plan(64, 8, chunk=16, device=CPU).key.chunk == 16


def test_range_route_consults_maxiter_polish(fresh_cache):
    _seed({ttune.coord_key("range", n=256, bucket=0, dtype="float64", k=8):
           {"maxiter": 48, "polish": 1}})
    names = ("n", "k_bucket", "dtype", "maxiter", "polish")
    got = tplan.resolve_range_route(256, 8, device=CPU)
    assert _fields(got, names) == _fields(jplan.resolve_range_route(256, 8),
                                          names)
    assert (got.maxiter, got.polish) == (48, 1)
    # A width in the same k bucket shares the entry; explicit knobs win.
    assert tplan.resolve_range_route(256, 5, device=CPU).maxiter == 48
    got = tplan.resolve_range_route(256, 8, maxiter=64, device=CPU)
    assert (got.maxiter, got.polish) == (64, 1)
    # An untuned coordinate: the built-in defaults.
    other = tplan.resolve_range_route(128, 4, device=CPU)
    assert (other.maxiter, other.polish) == (tbis.DEFAULT_MAX_BISECT,
                                             tbis.DEFAULT_POLISH)
    assert _fields(other, names) == _fields(
        jplan.resolve_range_route(128, 4), names)


def test_provenance_counters_in_plan_cache_stats(fresh_cache):
    _seed({ttune.coord_key("solve", n=64, bucket=0, dtype="float64"):
           {"stream_threshold": 48},
           ttune.coord_key("range", n=256, bucket=0, dtype="float64", k=8):
           {"polish": 1}})
    for plan in (jplan, tplan):
        plan.clear_plan_cache()   # zero the counters, reload the cache
    for args in ((64,), (128,), (64, 5)):
        tplan.resolve_solve_route(args[0], device=CPU,
                                  leaf=args[1] if len(args) > 1 else None)
        jplan.resolve_solve_route(args[0], mesh=None,
                                  leaf=args[1] if len(args) > 1 else None)
    for n, k in ((256, 8), (128, 4)):
        tplan.resolve_range_route(n, k, device=CPU)
        jplan.resolve_range_route(n, k)
    # Fully explicit routes do not consult.
    explicit = dict(leaf=32, stream_threshold=0, deflate_budget=64,
                    resident_threshold=0)
    tplan.resolve_solve_route(64, device=CPU, **explicit)
    jplan.resolve_solve_route(64, mesh=None, **explicit)
    got, want = tplan.plan_cache_stats(), jplan.plan_cache_stats()
    assert (got["tuned_routes"], got["default_routes"]) == \
        (want["tuned_routes"], want["default_routes"]) == (2, 3)
    assert got["tuning_cache"]["entries"] == 2
    assert got["tuning_cache"]["fingerprint"] == ttune.fingerprint(CPU)
    assert got["tuning_cache"]["path"] == ttune.cache_path(CPU)
    assert got["tuning_cache"]["error"] is None
    tplan.clear_plan_cache()
    stats = tplan.plan_cache_stats()
    assert (stats["tuned_routes"], stats["default_routes"]) == (0, 0)


def test_tuned_request_and_explicit_request_same_key_same_bits(fresh_cache):
    _seed({ttune.coord_key("solve", n=64, bucket=0, dtype="float64"):
           {"leaf": 16, "deflate_budget": 16, "stream_threshold": 64}})
    d, e = _problem(60, B=3, seed=4)
    tuned = route_request(SolveRequest(d=d, e=e, kind="batch",
                                       device=CPU)).route
    explicit_knobs = {"leaf": 16, "deflate_budget": 16,
                      "stream_threshold": 64, "resident_threshold": 0}
    explicit = route_request(SolveRequest(d=d, e=e, kind="batch",
                                          knobs=explicit_knobs,
                                          device=CPU)).route
    assert tuned == explicit
    a = eigvalsh_tridiagonal_batch(d, e, device=CPU).eigenvalues
    b = eigvalsh_tridiagonal_batch(d, e, device=CPU,
                                   **explicit_knobs).eigenvalues
    assert torch.equal(a, b)


# --------------------------------------------------------- the round trip


def test_tune_roundtrip_and_bit_identical_solves(fresh_cache):
    n, B = 48, 2
    report = tplan.tune([{"kind": "solve", "n": n, "batch": B}], iters=1,
                        device=CPU)
    assert report["path"] == ttune.cache_path(CPU)
    with open(report["path"]) as f:
        payload = json.load(f)
    assert payload["version"] == ttune.TUNE_CACHE_VERSION
    assert payload["fingerprint"] == ttune.fingerprint(CPU)
    assert payload["entries"] == report["entries"]
    for ent in payload["entries"].values():
        assert ent["ratio"] >= 1.0            # never ships a regression
    # Every knob the CPU grids race is written somewhere.
    written = set()
    for ent in payload["entries"].values():
        written |= set(ent["knobs"])
    assert written == {"leaf", "chunk", "stream_threshold",
                       "deflate_budget", "resident_threshold"}

    # A fresh consult: every memo dropped, the winners read from disk.
    tplan.clear_plan_cache()
    route = tplan.resolve_solve_route(n, device=CPU)
    N0 = tplan.resolve_solve_route(n, leaf=tplan.LEAF_DEFAULT,
                                   device=CPU).padded_n
    assert route.leaf == ttune.lookup("solve", n=N0, dtype="float64",
                                      device=CPU)["leaf"]
    tree = ttune.lookup("solve", n=route.padded_n, dtype="float64",
                        device=CPU)
    for knob in ("stream_threshold", "deflate_budget",
                 "resident_threshold"):
        assert getattr(route, knob) == tree[knob], knob
    assert tplan.plan_cache_stats()["tuned_routes"] >= 1

    explicit = dict(leaf=route.leaf, stream_threshold=route.stream_threshold,
                    deflate_budget=route.deflate_budget,
                    resident_threshold=route.resident_threshold)
    assert tplan.resolve_solve_route(n, device=CPU, **explicit) == route
    d, e = _problem(n, B)
    plan_t = tplan.make_plan(n, B, device=CPU)
    plan_e = tplan.make_plan(n, B, device=CPU, **explicit)
    assert plan_t is plan_e                   # one plan, one key
    lam_tuned = eigvalsh_tridiagonal_batch(d, e, device=CPU).eigenvalues
    lam_explicit = eigvalsh_tridiagonal_batch(d, e, device=CPU,
                                              **explicit).eigenvalues
    assert torch.equal(lam_tuned, lam_explicit)


def test_range_and_serve_tuning_roundtrip(fresh_cache):
    spec = [{"kind": "range", "n": 24, "k": 2},
            {"kind": "serve", "n": 24, "requests": 4, "threads": 2}]
    report = tplan.tune(spec, iters=1, device=CPU)
    entries = report["entries"]
    d, e = _problem(24, B=1)
    label = bucket_label(route_request(SolveRequest(
        d=d[0], e=e[0], device=CPU)).route)
    assert set(entries) == {
        ttune.coord_key("range", n=24, bucket=0, dtype="float64", k=2),
        f"serve|{label}"}
    for ent in entries.values():
        assert ent["ratio"] >= 1.0
    tplan.clear_plan_cache()
    rng_knobs = entries[ttune.coord_key("range", n=24, bucket=0,
                                        dtype="float64", k=2)]["knobs"]
    route = tplan.resolve_range_route(24, 2, device=CPU)
    assert (route.maxiter, route.polish) == (rng_knobs["maxiter"],
                                             rng_knobs["polish"])
    # The range winner passed the 8 eps ||T|| gate against the defaults.
    tuned = tbis.eigvalsh_tridiagonal_range(d[0], e[0], il=22, iu=23,
                                            device=CPU)
    ref = tbis.eigvalsh_tridiagonal_range(d[0], e[0], il=22, iu=23,
                                          maxiter=tbis.DEFAULT_MAX_BISECT,
                                          polish=tbis.DEFAULT_POLISH,
                                          device=CPU)
    normT = np.abs(d).max() + 2 * np.abs(e).max()
    assert float((tuned - ref).abs().max()) <= 8 * np.finfo(
        np.float64).eps * max(normT, 1.0)
    # A serve winner is kept only if it gains more than the defaults'
    # drains spread in the same run.
    ent = entries[f"serve|{label}"]
    base = ttune.backend_defaults(CPU)
    assert ent["drain_spread"] >= 1.0
    assert ent["knobs"] == {"max_batch": base["max_batch"],
                            "max_wait_us": base["max_wait_us"]} \
        or ent["ratio"] >= ent["drain_spread"]
    serve = ent["knobs"]
    sched = CoalescingScheduler(ServeConfig(max_batch=7, max_wait_us=123))
    assert sched._limits_for(route_request(SolveRequest(
        d=d[0], e=e[0], device=CPU)).route) == (serve["max_batch"],
                                                 serve["max_wait_us"])
    sched.close()


# ---------------------------------------------- defaults and the grids


def test_defaults_rows_carry_every_knob_the_consult_falls_back_to():
    from repro_torch.serve.scheduler import ServeConfig as TConfig
    cfg = TConfig()
    for kind in ("cpu", "cuda"):
        row = ttune.backend_defaults(kind)
        for knob in ("leaf", "chunk", "stream_threshold",
                     "resident_threshold", "deflate_budget", "maxiter",
                     "polish", "max_batch", "max_wait_us"):
            assert knob in row, (kind, knob)
        assert row["maxiter"] == tbis.DEFAULT_MAX_BISECT
        assert row["polish"] == tbis.DEFAULT_POLISH
        assert (row["max_batch"], row["max_wait_us"]) == (cfg.max_batch,
                                                          cfg.max_wait_us)
    assert ttune.backend_defaults(CPU)["leaf"] == tplan.LEAF_DEFAULT


def test_grids_per_device_type():
    cpu = {k: v for k, v, _ in ttune._SOLVE_GRIDS["cpu"]}
    j_grids = dict(jtune._solve_grids(1 << 20, jtune.backend_defaults()))
    assert {k: list(v) for k, v in cpu.items()} == j_grids
    cuda = {k: v for k, v, _ in ttune._SOLVE_GRIDS["cuda"]}
    # Only knobs that select something on the card are raced there.
    assert set(cuda) == {"resident_threshold"}
    assert max(cuda["resident_threshold"]) <= ttune.RESIDENT_THRESHOLD_CUDA
    assert ttune.backend_defaults("cuda")["resident_threshold"] in \
        cuda["resident_threshold"]
    assert tuple(ttune._LEAF_GRID) == tuple(jtune._LEAF_GRID)
    waits = dict(ttune._SERVE_GRIDS["cuda"])["max_wait_us"]
    assert max(waits) >= 40000 and {200, 500, 1000, 2000} <= set(waits)
    assert dict(ttune._SERVE_GRIDS["cpu"])["max_wait_us"] == (200, 500,
                                                              1000, 2000)


def test_save_entries_merges_and_replaces_a_foreign_file(fresh_cache):
    path = ttune.cache_path(CPU)
    with open(path, "w") as f:
        json.dump({"version": ttune.TUNE_CACHE_VERSION,
                   "fingerprint": {"backend": "cpu", "torch": "0.0"},
                   "entries": {"solve|n64|b0|float64|native|s1|k0":
                               {"knobs": {"leaf": 16}}}}, f)
    a = ttune.coord_key("solve", n=128, bucket=0, dtype="float64")
    b = ttune.coord_key("solve", n=256, bucket=0, dtype="float64")
    ttune._save_entries({a: {"knobs": {"leaf": 64}}}, CPU)
    ttune._save_entries({b: {"knobs": {"leaf": 16}}}, CPU)
    with open(path) as f:
        payload = json.load(f)
    assert set(payload["entries"]) == {a, b}   # the foreign entry is gone
    assert not [p for p in os.listdir(fresh_cache) if ".tmp." in p]
    assert ttune.lookup("solve", n=128, dtype="float64",
                        device=CPU) == {"leaf": 64}


def test_tuning_modules_import_no_jax():
    code = ("import sys; import repro_torch.core.tune, "
            "repro_torch.core.plan, repro_torch.spectral, "
            "repro_torch.optim; bad = sorted(m for m in sys.modules if "
            "m == 'jax' or m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": SRC},
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
