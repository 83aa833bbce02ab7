"""Backend-aware knob defaults, the on-device knob search and the
persistent tuning cache for the port.

Ported from ``repro.core.tune``: the defaults table, the tuning cache
(reader :func:`lookup` / :func:`serve_knobs` and writer
:func:`_save_entries`) and the knob search :func:`tune_workload`
(re-exported as ``plan.tune``).  ``plan.resolve_solve_route``,
``resolve_range_route`` and ``plan_for_route`` consult the cache for every
knob that arrives as ``None`` (tuned winner first, the device row's
default second), and the serve scheduler consults :func:`serve_knobs` per
route bucket.

The port routes by *device*, not by a process-wide backend: a CPU tensor
runs the plain torch versions and a CUDA tensor runs the hand-written
kernels, in the same process.  So the table has one row per device type,
each device type has its own cache file and candidate grids, and callers
pick the row of the device their tensors live on.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings

import numpy as np
import torch

_LOCK = threading.RLock()
_BACKEND: str | None = None

TUNE_CACHE_VERSION = 1

# Environment override for the cache directory (the JAX package's
# variable: one directory holds both packages' files, which never share a
# name); default under ~/.cache.
TUNE_CACHE_ENV = "REPRO_TUNE_CACHE"
_DEFAULT_CACHE_DIR = os.path.join("~", ".cache", "repro-tune")

# Loaded-cache memo per device type: entries (possibly empty) and why a
# file was rejected (None: accepted or absent).  The degradation warning
# fires once per load.
_CACHE: dict[str, dict] = {}
_CACHE_ERROR: dict[str, str | None] = {}

# Route-provenance counters (surfaced via plan_cache_stats): a route
# resolution that filled at least one None knob from the tuning cache
# counts as tuned, every other resolution that consulted counts default.
_CONSULTS = {"tuned_routes": 0, "default_routes": 0}

# Largest merge size K the resident kernel (csrc/resident_merge.cu) takes.
# Each CTA of it keeps one merge lane's O(K) vectors in shared memory: d,
# z (then zhat), d[origin] and tau, plus the r selected rows, i.e.
# (4 + r) * K * itemsize bytes.  The worst case on the main path is r = 3
# rows in float64: 7 * K * 8 = 56 K bytes.  A Hopper block can use at most
# 232,448 bytes of dynamic shared memory, so K <= 4150; merge sizes are
# 2 * leaf * 2^l, and K = 2048 (114,688 bytes, two CTAs to an SM) is the
# threshold.
RESIDENT_THRESHOLD_CUDA = 2048

# Sturm chains whose issue time still fits under one chain's latency on
# the card: the bisection tree (csrc/sturm_count.cu) counts this many node
# chains in about the time of one.  132 SMs x 128 issue slots a cycle x
# 1.926 GHz x 77.61 ns (one row of the chain, the chain probe) / 37.62
# instructions a row of the tree's loop (its SASS), about 67k
# (chip_smoke.py's ``[2 bound] bisection tree`` line re-derives it).  On
# an H100 the depths it gives (8 for a k = 64 range solve, 6 for the
# edges probes of B = 64 x 4096, 4 for ``method="bisect"`` at n = 4096)
# were also the fastest per halving of all depths 1-8
# (scripts/time_merge_kernels.py --kernels sturm --sweep).
BISECT_CHAINS_CUDA = 67000

# Deepest bisection tree one launch counts (kernels/sturm_count.MAX_DEPTH).
MAX_BISECT_DEPTH = 8

# Knobs both rows share: the range solve's halving cap and Newton polish
# steps (core/bisect.py's DEFAULT_MAX_BISECT and DEFAULT_POLISH, which
# import this module) and the serve scheduler's flush triggers
# (serve/scheduler.py's ServeConfig).
_SHARED = {"maxiter": 96, "polish": 2, "max_batch": 64, "max_wait_us": 2000}

_DEFAULTS = {
    # CPU: the plain torch versions.  As in the JAX package, everything
    # streams (stream_threshold 0) and the resident single-dispatch merge
    # is off (resident_threshold 0): on the CPU its dense (K, K) tile is
    # pure memory overhead.
    # bisect_chains 0: the CPU's bisection runs one halving a sweep (depth
    # 1), the plain host loop of the JAX package.
    "cpu": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
            "resident_threshold": 0, "deflate_budget": 64, "niter": 16,
            "bisect_chains": 0, **_SHARED},
    # CUDA: the hand-written kernels tile the pole axis themselves and
    # have no dense mode, so stream_threshold selects nothing there (0).
    # resident_threshold is the shared-memory fit derived above, and
    # bisect_chains the chain count under one chain's latency.
    "cuda": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
             "resident_threshold": RESIDENT_THRESHOLD_CUDA,
             "deflate_budget": 64, "niter": 16,
             "bisect_chains": BISECT_CHAINS_CUDA, **_SHARED},
}


def pinned_backend() -> str:
    """``"cuda"`` when a CUDA card is visible, else ``"cpu"``; probed once
    and pinned for the life of the process."""
    global _BACKEND
    if _BACKEND is None:
        with _LOCK:
            if _BACKEND is None:
                _BACKEND = "cuda" if torch.cuda.is_available() else "cpu"
    return _BACKEND


def backend_defaults(backend: str | None = None) -> dict:
    """The knob-defaults row of ``backend`` (a device type, ``"cuda"`` or
    ``"cpu"``; None: :func:`pinned_backend`)."""
    backend = backend or pinned_backend()
    if backend not in _DEFAULTS:
        raise ValueError(f"no knob defaults for device type {backend!r}; "
                         f"the port runs on {tuple(_DEFAULTS)}")
    return dict(_DEFAULTS[backend])


def bisect_depth(brackets: int, chains: int) -> int:
    """Halvings a bisection launch takes for ``brackets`` brackets when
    ``chains`` chains cost the time of one: the deepest tree whose
    brackets * (2^m - 1) node chains fit, m = floor(log2(chains /
    brackets + 1)), within [1, MAX_BISECT_DEPTH]."""
    m = (chains // max(1, brackets) + 1).bit_length() - 1
    return max(1, min(MAX_BISECT_DEPTH, m))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    None means the card: entry points run on ``cuda`` unless the caller
    asks for the CPU.  With no card visible that is an error, never a
    quiet fallback to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "visible; pass device='cpu' to run the plain torch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               f"visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got "
                         f"device={device!r}")
    return dev


# --------------------------------------------------------------------------
# Persistent tuning cache (reader)
# --------------------------------------------------------------------------


def _device_type(device=None) -> str:
    if device is None:
        return pinned_backend()
    return torch.device(device).type


def cache_dir() -> str:
    return os.path.expanduser(
        os.environ.get(TUNE_CACHE_ENV) or _DEFAULT_CACHE_DIR)


def _device_name(device_type: str) -> str:
    if device_type != "cuda":
        return device_type
    try:
        return torch.cuda.get_device_name(0)
    except Exception:
        return "unknown"


def fingerprint(device=None) -> dict:
    """What must match for a cache file's timings to be trusted here: the
    device's name and the torch and CUDA versions."""
    kind = _device_type(device)
    return {"backend": kind, "device_name": _device_name(kind),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def cache_path(device=None) -> str:
    """Cache file path, one per device type (CPU and card runs on one box
    never share a file).  The name is the port's own: the JAX package's
    ``tune-<backend>.json`` in the same directory is never read."""
    return os.path.join(cache_dir(),
                        f"torch-tune-{_device_type(device)}.json")


def coord_key(kind: str, *, n: int, bucket: int, dtype: str,
              precision: str = "native", shards: int = 1,
              k: int = 0) -> str:
    """Serialize a tuning coordinate (the JAX package's format).  ``n`` is
    the padded problem size for solve coordinates and the problem size
    for range coordinates (``k`` carries the range slice bucket);
    ``bucket`` == 0 means the route-level (batch-agnostic) entry."""
    return f"{kind}|n{int(n)}|b{int(bucket)}|{dtype}|{precision}" \
           f"|s{int(shards)}|k{int(k)}"


def _load_locked(kind: str) -> dict:
    """Load (memoized) the device type's cache entries; never raises.

    A missing file is silent.  Any defect -- unreadable file, broken JSON,
    wrong schema version, foreign fingerprint -- degrades to an empty
    entry set with a single RuntimeWarning, so every consult falls back
    to the built-in defaults.
    """
    entries = _CACHE.get(kind)
    if entries is not None:
        return entries
    path = cache_path(kind)
    entries = {}
    error: str | None = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError("tuning cache is not a JSON object")
            if payload.get("version") != TUNE_CACHE_VERSION:
                error = (f"version {payload.get('version')!r} != "
                         f"{TUNE_CACHE_VERSION}")
            elif payload.get("fingerprint") != fingerprint(kind):
                error = (f"fingerprint {payload.get('fingerprint')!r} does "
                         f"not match this machine {fingerprint(kind)!r}")
            else:
                raw = payload.get("entries")
                if not isinstance(raw, dict):
                    raise ValueError("tuning cache has no entries dict")
                for key, ent in raw.items():
                    if isinstance(ent, dict) and isinstance(
                            ent.get("knobs"), dict):
                        entries[key] = ent
        except Exception as exc:  # corrupt/unreadable: degrade, never raise
            error = f"{type(exc).__name__}: {exc}"
        if error is not None:
            entries = {}
            warnings.warn(
                f"ignoring tuning cache {path} ({error}); solves fall "
                f"back to built-in defaults", RuntimeWarning, stacklevel=3)
    _CACHE[kind] = entries
    _CACHE_ERROR[kind] = error
    return entries


def reload_tuning_cache() -> None:
    """Drop the loaded-cache memo; the next consult re-reads the file
    (and re-resolves ``$REPRO_TUNE_CACHE``)."""
    with _LOCK:
        _CACHE.clear()
        _CACHE_ERROR.clear()


def lookup(kind: str, *, n: int, bucket: int = 0, dtype: str,
           precision: str = "native", shards: int = 1, k: int = 0,
           device=None) -> dict:
    """Tuned knobs for a coordinate on ``device``'s type (falls back from
    the exact batch bucket to the route-level ``bucket=0`` entry).
    Returns ``{}`` when the coordinate was never tuned; never raises."""
    with _LOCK:
        entries = _load_locked(_device_type(device))
        for b in ((bucket, 0) if bucket else (0,)):
            ent = entries.get(coord_key(kind, n=n, bucket=b, dtype=dtype,
                                        precision=precision, shards=shards,
                                        k=k))
            if ent is not None:
                return dict(ent["knobs"])
    return {}


def serve_knobs(label: str, device=None) -> dict:
    """Tuned serve-scheduler knobs (max_batch / max_wait_us) for a route
    bucket label (``serve.metrics.bucket_label``) on ``device``'s type.
    ``{}`` if untuned."""
    with _LOCK:
        ent = _load_locked(_device_type(device)).get(f"serve|{label}")
        return dict(ent["knobs"]) if ent is not None else {}


def note_route(used_tuned: bool) -> None:
    """Provenance tick from the route resolvers (plan_cache_stats)."""
    with _LOCK:
        _CONSULTS["tuned_routes" if used_tuned else "default_routes"] += 1


def reset_consult_stats() -> None:
    with _LOCK:
        _CONSULTS["tuned_routes"] = 0
        _CONSULTS["default_routes"] = 0


def tuning_stats(device=None) -> dict:
    """Tuning-cache observability: file and fingerprint state, entry count
    and the tuned/default route-provenance counters."""
    kind = _device_type(device)
    with _LOCK:
        entries = _load_locked(kind)
        return {"path": cache_path(kind),
                "entries": len(entries),
                "fingerprint": fingerprint(kind),
                "error": _CACHE_ERROR.get(kind),
                "backend": kind,
                "tuned_routes": _CONSULTS["tuned_routes"],
                "default_routes": _CONSULTS["default_routes"]}


def _save_entries(new_entries: dict, device=None) -> str:
    """Merge winners into ``device``'s type's cache file (written to a temp
    file and renamed into place) and reload; returns the path."""
    kind = _device_type(device)
    path = cache_path(kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    merged: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                payload = json.load(f)
            if (payload.get("version") == TUNE_CACHE_VERSION
                    and payload.get("fingerprint") == fingerprint(kind)
                    and isinstance(payload.get("entries"), dict)):
                merged = payload["entries"]
        except Exception:
            merged = {}   # unreadable: the new file replaces it
    merged.update(new_entries)
    payload = {"version": TUNE_CACHE_VERSION, "fingerprint": fingerprint(kind),
               "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "entries": merged}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    reload_tuning_cache()
    return path


# --------------------------------------------------------------------------
# On-device knob search
# --------------------------------------------------------------------------

# A candidate must beat the incumbent by this fraction to be accepted:
# best-of interleaved timing plus a margin keeps repeated runs on one
# machine from flapping between winners on scheduler noise.
ACCEPT_MARGIN = 0.03

# Leaf block sizes raced on both device types.  On the card the leaf sets
# the batched torch.linalg.eigh of the leaves and the depth of the tree.
_LEAF_GRID = (16, 32, 64)

# Tree knobs raced per device type, as (knob, candidates).
#   cpu:  the JAX package's grids, so the CPU tests mirror the reference.
#   cuda: only knobs that select something on the card.  The resident
#         merge takes every level with K <= resident_threshold in one
#         launch, never above RESIDENT_THRESHOLD_CUDA (above it the
#         kernel's shared memory does not fit and it raises), and 0 runs
#         every level as root solve + post-pass.  stream_threshold (no
#         dense mode on the card: 0), deflate_budget (the chain kernel
#         runs the whole chain: unused on the card) and chunk (the CUDA
#         kernels tile themselves; only the plain versions take it) are
#         not raced: racing them could only pick up noise, so their
#         entries stay absent and the consult falls back to the defaults.
_SOLVE_GRIDS = {
    "cpu": (("stream_threshold", (0, 64, 256, 512), 0),
            ("deflate_budget", (16, 32, 64, 128), 1),
            ("resident_threshold", (0, 256, 512), 0),
            ("chunk", (32, 64, 128, 256), 8)),
    "cuda": (("resident_threshold",
              tuple(v for v in (0, 512, 1024, 2048)
                    if v <= RESIDENT_THRESHOLD_CUDA), 0),),
}

# Range knobs: maxiter caps the bisection halvings (on the card the tree
# takes up to 8 a launch, so 32 / 48 / 64 are 4 / 6 / 8 launches) and
# polish counts the Newton sweeps, so both select work on either device
# type; the grid is the JAX package's.
_RANGE_GRID = (("maxiter", (32, 48, 64)), ("polish", (0, 1)))

# Serve flush triggers per device type.
#   cpu:  the JAX package's grids.
#   cuda: 16 threads take 35-40 ms to submit a burst of 64 requests on the
#         card's host (PERF.md section 6), so a wait that holds a whole
#         burst in one flush must reach about 40,000 us; the JAX package's
#         waits (200-2000 us) flush a burst in pieces.
_SERVE_GRIDS = {
    "cpu": (("max_batch", (8, 16, 32, 64)),
            ("max_wait_us", (200, 500, 1000, 2000))),
    "cuda": (("max_batch", (8, 16, 32, 64)),
             ("max_wait_us", (200, 500, 1000, 2000, 5000, 10000, 20000,
                              40000))),
}


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _race(fn_inc, fn_cand, iters: int, dev: torch.device):
    """Interleaved best-of race: incumbent and candidate alternate so
    background drift hits both; best-of because spikes only ever inflate
    a sample.  Each call is waited for (``torch.cuda.synchronize`` on the
    card) and timed on the host clock: the time a caller waits."""
    for fn in (fn_inc, fn_cand):
        fn()
        _wait(dev)
    ti, tc = [], []
    for _ in range(iters):
        for fn, acc in ((fn_inc, ti), (fn_cand, tc)):
            t0 = time.perf_counter()
            fn()
            _wait(dev)
            acc.append(time.perf_counter() - t0)
    return min(ti), min(tc)


def _problem(n: int, batch: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic workload (fixed seed: reproducible runs)."""
    rng = np.random.default_rng(20260810)
    d = rng.standard_normal((batch, n)).astype(dtype)
    e = rng.standard_normal((batch, max(n - 1, 0))).astype(dtype)
    return d, e


def _descend(current: dict, grids, make_fn, iters: int, dev,
             accept_extra=None) -> dict:
    """One pass of coordinate descent: for each knob, race every listed
    candidate against the incumbent and keep winners that clear
    ``ACCEPT_MARGIN`` (and the optional accuracy gate)."""
    for knob, candidates in grids:
        for cand in candidates:
            if cand == current[knob]:
                continue
            trial = dict(current)
            trial[knob] = cand
            try:
                fn_cand = make_fn(trial)
            except Exception:
                continue   # infeasible combination
            if accept_extra is not None and not accept_extra(fn_cand):
                continue
            t_inc, t_cand = _race(make_fn(current), fn_cand, iters, dev)
            if t_cand < t_inc * (1.0 - ACCEPT_MARGIN):
                current = trial
    return current


def _settle(base: dict, current: dict, t_def: float, t_tuned: float):
    """The never-regress rule on a final race of the defaults against the
    winner: (knobs, default time, tuned time).  A winner that is the
    defaults reads one time for both (its two samples time the same
    knobs); a winner that does not beat the defaults gives way to them."""
    if current == base:
        t = min(t_def, t_tuned)
        return dict(base), t, t
    if t_tuned >= t_def:
        return dict(base), t_def, t_def
    return current, t_def, t_tuned


def _stamp(t_def: float, t_tuned: float, **extra) -> dict:
    return {"baseline_us": round(t_def * 1e6, 1),
            "tuned_us": round(t_tuned * 1e6, 1),
            "ratio": round(t_def / max(t_tuned, 1e-12), 3), **extra,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S")}


def _tune_solve(spec: dict, iters: int, log, dev: torch.device) -> dict:
    """Tune one full-spectrum coordinate; returns its cache entries."""
    from repro_torch.core import plan as _plan

    n = int(spec["n"])
    batch = int(spec.get("batch", 1))
    precision = spec.get("precision", "native")
    defaults = backend_defaults(dev.type)
    tiers = _SOLVE_GRIDS[dev.type]
    base = {"leaf": int(spec.get("leaf", defaults["leaf"])),
            **{k: defaults[k] for k in ("chunk", "stream_threshold",
                                        "deflate_budget",
                                        "resident_threshold")}}

    def plan_of(knobs):
        return _plan.make_plan(n, batch, device=dev, dtype=spec.get("dtype"),
                               precision=precision, **knobs)

    key0 = plan_of(base).key
    d, e = _problem(n, batch, np.dtype(key0.dtype))
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev)

    def make_fn(knobs):
        p = plan_of(knobs)
        return lambda: p.execute(d, e).eigenvalues

    grids = [(knob, [v for v in vals if lo <= v <= 2 * key0.padded_n])
             for knob, vals, lo in tiers]
    current = _descend(base, [("leaf", [lf for lf in _LEAF_GRID
                                        if lf <= max(n, 1)])],
                       make_fn, iters, dev)
    current = _descend(current, grids, make_fn, iters, dev)

    # Never ship a regression: the winner must beat the defaults in a
    # final interleaved race.
    current, t_def, t_tuned = _settle(
        base, current, *_race(make_fn(base), make_fn(current), iters, dev))

    key_t = plan_of(current).key     # padded N under the winning leaf
    stamp = _stamp(t_def, t_tuned, batch=batch)
    entries: dict = {}

    def put(coord: str, knobs: dict) -> None:
        # Coordinates collide when the winning leaf pads like the default
        # one: merge the knob dicts instead of overwriting.
        if knobs:
            ent = entries.setdefault(coord, {"knobs": {}, **stamp})
            ent["knobs"].update(knobs)

    tree = [k for k, _, _ in tiers if k != "chunk"]
    # The leaf under the default leaf's padded size (the coordinate the
    # consult looks up before the tree shape is known); the tree knobs
    # under the winning leaf's; chunk per batch bucket (consulted by
    # plan_for_route once the launch bucket is known).
    put(coord_key("solve", n=key0.padded_n, bucket=0, dtype=key0.dtype,
                  precision=precision), {"leaf": current["leaf"]})
    put(coord_key("solve", n=key_t.padded_n, bucket=0, dtype=key_t.dtype,
                  precision=precision), {k: current[k] for k in tree})
    if any(k == "chunk" for k, _, _ in tiers):
        put(coord_key("solve", n=key_t.padded_n,
                      bucket=_plan.batch_bucket(batch), dtype=key_t.dtype,
                      precision=precision), {"chunk": current["chunk"]})
    log(f"solve n={n} B={batch} on {dev.type}: {current} "
        f"({t_def * 1e6:.0f}us -> {t_tuned * 1e6:.0f}us, "
        f"x{stamp['ratio']:.2f})")
    return entries


def _tune_range(spec: dict, iters: int, log, dev: torch.device) -> dict:
    """Tune one sliced-solve coordinate (maxiter / polish budgets).

    Both knobs bear on accuracy (fewer halvings or polish steps can
    loosen roots), so a candidate is raced only after it stays within
    8 eps ||T|| of the default-knob solve on the same workload (the range
    API's contract).
    """
    from repro_torch.core import plan as _plan

    n = int(spec["n"])
    k = int(spec.get("k", min(32, n)))
    batch = int(spec.get("batch", 1))
    defaults = backend_defaults(dev.type)
    base = {"maxiter": defaults["maxiter"], "polish": defaults["polish"]}

    def plan_of(knobs):
        return _plan.make_range_plan(n, k, batch, dtype=spec.get("dtype"),
                                     device=dev, **knobs)

    key = plan_of(base).key
    d, e = _problem(n, batch, np.dtype(key.dtype))
    normT = np.abs(d).max() + 2 * (np.abs(e).max() if n > 1 else 0.0)
    tol = 8.0 * np.finfo(d.dtype).eps * max(normT, 1.0)
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev)
    il = max(0, n - k)

    def make_fn(knobs):
        p = plan_of(knobs)
        return lambda: p.execute(d, e, il, k)

    ref = make_fn(base)().cpu().numpy()

    def accurate(fn_cand) -> bool:
        return bool(np.max(np.abs(fn_cand().cpu().numpy() - ref)) <= tol)

    grids = [(knob, list(vals) + [base[knob]]) for knob, vals in _RANGE_GRID]
    current = _descend(base, grids, make_fn, iters, dev,
                       accept_extra=accurate)
    current, t_def, t_tuned = _settle(
        base, current, *_race(make_fn(base), make_fn(current), iters, dev))
    entry = {"knobs": dict(current), **_stamp(t_def, t_tuned, batch=batch)}
    log(f"range n={n} k={k} on {dev.type}: {current} "
        f"({t_def * 1e6:.0f}us -> {t_tuned * 1e6:.0f}us, "
        f"x{entry['ratio']:.2f})")
    return {coord_key("range", n=n, bucket=0, dtype=key.dtype,
                      k=key.k_bucket): entry}


def _tune_serve(spec: dict, iters: int, log, dev: torch.device) -> dict:
    """Tune the serve scheduler's flush triggers for one route bucket.

    Each candidate (max_batch, max_wait_us) runs a real EigensolverClient
    with the route's plans prewarmed and times the drain of a fixed burst:
    ``threads`` threads each submit their share of ``requests`` single
    n-problem requests (``solve_async``) and every future is awaited, the
    burst of ``chip_smoke.py``'s service phase.
    """
    from repro_torch.core.request import SolveRequest, route_request
    from repro_torch.serve.client import EigensolverClient
    from repro_torch.serve.metrics import bucket_label

    n = int(spec["n"])
    requests = int(spec.get("requests", 48))
    threads = int(spec.get("threads", 4))
    defaults = backend_defaults(dev.type)
    base = {"max_batch": defaults["max_batch"],
            "max_wait_us": defaults["max_wait_us"]}
    d, e = (x[0] for x in _problem(n, 1, np.float64))
    label = bucket_label(route_request(
        SolveRequest(d=d, e=e, kind="full", device=dev)).route)

    def burst(client) -> float:
        futs: list = [None] * requests

        def worker(t):
            for i in range(t, requests, threads):
                futs[i] = client.solve_async(d, e, device=dev)

        t0 = time.perf_counter()
        pool = [threading.Thread(target=worker, args=(t,))
                for t in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        for f in futs:
            f.result()
        return time.perf_counter() - t0

    drains: dict = {}     # every drain of each knob setting in this run

    def drain_time(knobs) -> float:
        width = min(int(knobs["max_batch"]), 64)
        with EigensolverClient(
                prewarm=[{"kind": "solve", "n": n, "batch": b,
                          "device": dev} for b in sorted({1, width})],
                max_batch=int(knobs["max_batch"]),
                max_wait_us=int(knobs["max_wait_us"])) as client:
            burst(client)                 # warm the engine loop
            t = min(burst(client) for _ in range(max(2, iters // 2)))
            flushes = client.metrics()["buckets"][label]["flushes"]
        log(f"serve {label} on {dev.type}: {knobs} drains {requests} "
            f"requests in {t * 1e3:.1f} ms ({flushes} flushes in "
            f"{max(2, iters // 2) + 1} bursts)")
        drains.setdefault(tuple(sorted(knobs.items())), []).append(t)
        return t

    drain_time(base)
    current = dict(base)
    for knob, candidates in _SERVE_GRIDS[dev.type]:
        best_t = drain_time(current)
        for cand in candidates:
            if cand == current[knob]:
                continue
            trial = dict(current)
            trial[knob] = cand
            t = drain_time(trial)
            if t < best_t * (1.0 - ACCEPT_MARGIN):
                current, best_t = trial, t
    # The final race: the winner, then the defaults once more (their first
    # drain opened the race; a burst's drain varies from run to run).
    t_tuned = drain_time(current)
    drain_time(base)
    # The defaults drained at least three times; their spread is what one
    # setting varies by in this run.  A winner that gains no more than
    # that is not told apart from the defaults, and is not kept.
    t_base = drains[tuple(sorted(base.items()))]
    spread = max(t_base) / min(t_base)
    if min(t_base) < t_tuned * spread:
        current, t_tuned = dict(base), min(t_base)
    current, t_default, t_tuned = _settle(
        base, current, min(t_base), t_tuned)
    entry = {"knobs": dict(current),
             **_stamp(t_default, t_tuned, requests=requests,
                      threads=threads, drain_spread=round(spread, 3))}
    log(f"serve {label} on {dev.type}: {current} "
        f"({t_default * 1e3:.1f}ms -> {t_tuned * 1e3:.1f}ms, "
        f"x{entry['ratio']:.2f}; the defaults' drains spread "
        f"x{spread:.2f})")
    return {f"serve|{label}": entry}


def tune_workload(workload_spec, *, iters: int = 5, save: bool = True,
                  log=None, device=None) -> dict:
    """Sweep the knob space on ``device`` (default: the card) for a
    workload and persist the winners to that device type's cache file.

    ``workload_spec`` is an iterable of dict entries in the ``prewarm``
    format, plus a serve kind::

        {"kind": "solve", "n": 1024, "batch": 8}      # tree knobs (+chunk)
        {"kind": "range", "n": 4096, "k": 32}          # maxiter / polish
        {"kind": "serve", "n": 128, "requests": 48, "threads": 4}

    Each entry is tuned per its ``(kind, padded N, batch bucket, dtype,
    precision)`` coordinate by coordinate descent over the device type's
    candidate grids, warm-started from its defaults row, with interleaved
    best-of host timing, and a final race against the defaults keeps a
    winner only if it is not slower.  The route resolvers pick the
    winners up for every knob that arrives as None.  Returns
    ``{"entries": {coord: {"knobs", "baseline_us", "tuned_us", "ratio",
    ...}}, "path": cache file or None, "seconds": s}``.
    """
    t0 = time.perf_counter()
    log = log or (lambda msg: None)
    dev = resolve_device(device)
    entries: dict = {}
    for spec in workload_spec:
        spec = dict(spec)
        kind = spec.pop("kind", "solve")
        if kind in ("solve", "batch", "full"):
            entries.update(_tune_solve(spec, iters, log, dev))
        elif kind == "range":
            entries.update(_tune_range(spec, iters, log, dev))
        elif kind == "serve":
            entries.update(_tune_serve(spec, iters, log, dev))
        else:
            raise ValueError(
                f"unknown tune kind {kind!r}; use solve/batch/full, "
                f"range, or serve")
    path = _save_entries(entries, dev) if (save and entries) else None
    return {"entries": entries, "path": path,
            "seconds": time.perf_counter() - t0}
