"""Deterministic fault injection (chaos harness): port copy of
``repro.runtime.faults``.

Chaos testing a numerical solver only works if the chaos is
*reproducible*.  This registry is therefore seeded and count-driven,
never wall-clock driven: each named SITE keeps a hit counter, and a
configured :class:`FaultSpec` fires exactly on the listed hit numbers of
its site.  Re-running the same traffic against the same schedule injects
the same faults at the same points.

Instrumented sites of the port (grep for the literal string):

    ``plan.launch``   -- raises after input staging, before the solve's
                         tree runs (transient RuntimeError or
                         deterministic ValueError, per ``error=``).
    ``plan.output``   -- NaN-poisons rows of the tree's eigenvalue output
                         (``lane``/``width``), before the mixed-precision
                         stage: the "device returned garbage" scenario the
                         degradation ladder exists for.
    ``serve.stage``   -- the serving engine's flush staging
                         (``repro_torch.serve.engine``): a delay stalls
                         it (the straggler monitor and watchdog see
                         it), an error demotes the flush to the
                         retry/fallback path.
    ``serve.launch``  -- hit once per flush launch *attempt*, so a
                         count-driven schedule can fail the first launch
                         and let the transient retry succeed.
    ``dist.halo``     -- corrupts one staged off-diagonal lane of a
                         sharded solve (default: the last entry, a
                         shard-boundary coupling) before the shards take
                         their slices (``core.plan``'s sharded executor).

The fast path is one module-global boolean: with no schedule configured
every hook is ``if not _ACTIVE: return`` and the solver's outputs are
bit-identical to a run without the harness.

Config is programmatic (:func:`configure_faults`) or operator-driven via
the ``REPRO_FAULTS`` environment variable (a JSON list of spec dicts).
State is reset by :func:`reset_faults`, which
``repro_torch.core.plan.clear_plan_cache`` calls.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from typing import Iterable, Mapping

KINDS = ("error", "nan", "delay", "corrupt")

# Module-global fast flag: every hook bails on one attribute read when no
# schedule is configured (the disabled path must cost nothing and change
# nothing).
_ACTIVE = False


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    site:    the instrumented hook name (see module docstring).
    kind:    "error" (raise), "nan" (poison output rows), "delay"
             (sleep), "corrupt" (damage one staged input value).
    times:   which hits of the site fire (0-based, deterministic); an
             empty tuple means every hit.
    error:   "transient" raises InjectedTransientError (a RuntimeError,
             so the retry/fallback machinery treats it as a real device
             fault); "deterministic" raises InjectedDeterministicError
             (a ValueError: retries must NOT fire).
    delay_s: sleep duration for kind="delay".
    lane:    first output row (kind="nan") / staged lane (kind="corrupt")
             to damage.
    width:   number of consecutive rows to poison (kind="nan").
    index:   column index to corrupt (kind="corrupt"; -1 = last).
    value:   the corrupted value (kind="corrupt").
    """
    site: str
    kind: str = "error"
    times: tuple = (0,)
    error: str = "transient"
    delay_s: float = 0.0
    lane: int = 0
    width: int = 1
    index: int = -1
    value: float = float("nan")

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.error not in ("transient", "deterministic"):
            raise ValueError(f"fault error class must be 'transient' or "
                             f"'deterministic', got {self.error!r}")
        object.__setattr__(self, "times", tuple(int(t) for t in self.times))


class InjectedTransientError(RuntimeError):
    """Injected stand-in for a transient device fault (preemption, flaky
    interconnect) -- a RuntimeError so ``retry_transient`` retries it."""


class InjectedDeterministicError(ValueError):
    """Injected stand-in for a deterministic failure -- a ValueError so
    the engine skips the (pointless) relaunch and falls straight back."""


class FaultInjector:
    """Thread-safe registry: schedule + per-site hit/fire counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {}
        self._hits: dict[str, int] = {}
        self._fired: dict[str, int] = {}

    def configure(self, specs: Iterable[FaultSpec | Mapping]) -> None:
        global _ACTIVE
        parsed = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                  for s in specs]
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            for s in parsed:
                self._specs.setdefault(s.site, []).append(s)
            _ACTIVE = bool(self._specs)

    def reset(self) -> None:
        global _ACTIVE
        with self._lock:
            self._specs.clear()
            self._hits.clear()
            self._fired.clear()
            _ACTIVE = False

    def due(self, site: str) -> FaultSpec | None:
        """Count one hit of ``site``; return the spec scheduled for this
        hit (None otherwise).  At most one spec fires per hit (first
        configured wins)."""
        with self._lock:
            specs = self._specs.get(site)
            if not specs:
                return None
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            for s in specs:
                if not s.times or hit in s.times:
                    self._fired[site] = self._fired.get(site, 0) + 1
                    return s
            return None

    def stats(self) -> dict:
        with self._lock:
            return {"active": _ACTIVE,
                    "sites": sorted(self._specs),
                    "hits": dict(self._hits),
                    "fired": dict(self._fired)}


INJECTOR = FaultInjector()


def faults_enabled() -> bool:
    return _ACTIVE


def configure_faults(specs=None) -> None:
    """Install a fault schedule.  ``specs`` is an iterable of
    :class:`FaultSpec` (or spec dicts); ``None`` reads the
    ``REPRO_FAULTS`` environment variable (JSON list, no-op if unset)."""
    if specs is None:
        raw = os.environ.get("REPRO_FAULTS", "")
        if not raw.strip():
            return
        specs = json.loads(raw)
    INJECTOR.configure(specs)


def reset_faults() -> None:
    INJECTOR.reset()


def fault_stats() -> dict:
    return INJECTOR.stats()


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


# ------------------------------------------------------------------ hooks
# Call sites use exactly these helpers; each is a no-op (one global read)
# when no schedule is installed.


def inject(site: str) -> None:
    """Raise / sleep if a fault is due at ``site`` (kinds error/delay)."""
    if not _ACTIVE:
        return
    spec = INJECTOR.due(site)
    if spec is None:
        return
    if spec.kind == "delay":
        time.sleep(spec.delay_s)
    elif spec.kind == "error":
        if spec.error == "transient":
            raise InjectedTransientError(
                f"injected transient fault at {site}")
        raise InjectedDeterministicError(
            f"injected deterministic fault at {site}")
    # nan/corrupt specs configured on an inject-only site do nothing.


def poison_rows(site: str, arr):
    """NaN-poison ``width`` rows of a (B, n) array or tensor if due
    (kind="nan"); a tensor is poisoned in a copy on its own device."""
    if not _ACTIVE:
        return arr
    spec = INJECTOR.due(site)
    if spec is None or spec.kind != "nan":
        return arr
    lo = spec.lane
    hi = min(lo + max(1, spec.width), arr.shape[0])
    arr = arr.clone() if _is_tensor(arr) else arr.copy()
    arr[lo:hi] = spec.value
    return arr


def corrupt_entry(site: str, arr):
    """Damage one entry of a staged (B, m) array or tensor if due
    (kind="corrupt")."""
    if not _ACTIVE:
        return arr
    spec = INJECTOR.due(site)
    if spec is None or spec.kind != "corrupt":
        return arr
    lane = min(spec.lane, arr.shape[0] - 1)
    index = spec.index if spec.index >= 0 else arr.shape[-1] - 1
    index = min(index, arr.shape[-1] - 1)
    arr = arr.clone() if _is_tensor(arr) else arr.copy()
    arr[lane, index] = spec.value
    return arr
