"""Backend-aware knob defaults and the persistent tuning cache's reader
for the port.

Ported from ``repro.core.tune``: the defaults table and the tuning
cache's reader (:func:`cache_path`, :func:`fingerprint`,
:func:`coord_key`, the loader, :func:`lookup`, :func:`serve_knobs`,
:func:`tuning_stats`).  The serve scheduler consults :func:`serve_knobs`
per route bucket.  Still to come (ROADMAP Queue 1 item 5): the writer
(``tune_workload``, ``_save_entries``), ``plan.tune`` and the route-time
consult of ``plan.resolve_solve_route`` / ``resolve_range_route``, so
every ``None`` solver knob resolves to the defaults table here.

The port routes by *device*, not by a process-wide backend: a CPU tensor
runs the plain torch versions and a CUDA tensor runs the hand-written
kernels, in the same process.  So the table has one row per device type
and callers pick the row of the device their tensors live on.
"""

from __future__ import annotations

import json
import os
import threading
import warnings

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

# Route-provenance counters (the route-time consult that ticks them comes
# with the tuning writer, ROADMAP Queue 1 item 5).
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

_DEFAULTS = {
    # CPU: the plain torch versions.  As in the JAX package, everything
    # streams (stream_threshold 0) and the resident single-dispatch merge
    # is off (resident_threshold 0): on the CPU its dense (K, K) tile is
    # pure memory overhead.
    # bisect_chains 0: the CPU's bisection runs one halving a sweep (depth
    # 1), the plain host loop of the JAX package.
    "cpu": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
            "resident_threshold": 0, "deflate_budget": 64, "niter": 16,
            "bisect_chains": 0},
    # CUDA: the hand-written kernels tile the pole axis themselves and
    # have no dense mode, so stream_threshold selects nothing there (0).
    # resident_threshold is the shared-memory fit derived above, and
    # bisect_chains the chain count under one chain's latency.
    "cuda": {"leaf": 32, "chunk": 256, "stream_threshold": 0,
             "resident_threshold": RESIDENT_THRESHOLD_CUDA,
             "deflate_budget": 64, "niter": 16,
             "bisect_chains": BISECT_CHAINS_CUDA},
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
