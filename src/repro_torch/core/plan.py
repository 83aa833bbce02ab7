"""Batch-first solve plans: static tree shape + bucketed plan cache (port of
``repro.core.plan``, full-spectrum plans only).

A plan captures everything static about a solve up front: the padded
problem size ``N = leaf * 2^L`` and depth ``L``, the per-level coupling
indices, the selected-row slots, and the batch bucket (request batches
rounded up to the next power of two; short batches are padded with
trivial dummy problems and sliced away).  Plans are cached process-wide
by :class:`PlanKey`, which carries the same knob fields as the JAX
package's key plus the device.

PyTorch runs eagerly, so there is no compiled executable behind a plan:
``EXECUTOR_TRACES`` counts *executor builds*, i.e. plan-cache misses --
the analogue of the JAX package's trace counter (a second same-bucket
request builds nothing).  Range plans, sharding, the tuning cache and
``prewarm`` come in later slices.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import torch

from repro_torch.core import br_dc as _br
from repro_torch.core import guard as _guard
from repro_torch.core import merge as _merge
from repro_torch.core import secular as _sec
from repro_torch.core.instrument import SolveCounter
from repro_torch.core.tune import resolve_device  # noqa: F401 (re-export)

# Built-in leaf block size (the tuning cache that may override it comes in
# a later slice).
LEAF_DEFAULT = 32

# Incremented once per executor build (plan-cache miss).
EXECUTOR_TRACES = SolveCounter("executor_traces")


class PlanKey(NamedTuple):
    """Bucketed plan-cache key; every field is static/hashable."""
    padded_n: int
    leaf: int
    batch_bucket: int
    dtype: str
    chunk: int
    niter: int
    use_zhat: bool
    return_boundary: bool
    tol_factor: float
    stream_threshold: int
    deflate_budget: int
    resident_threshold: int
    fused: bool
    device: str


def route_key_tuple(key) -> tuple:
    """(padded_n, leaf, batch_bucket, dtype, return_boundary) of a plan
    key of either package -- the fields that decide which bucket a
    request lands in, comparable across the JAX package and the port."""
    return (int(key.padded_n), int(key.leaf), int(key.batch_bucket),
            str(key.dtype), bool(key.return_boundary))


def batch_bucket(batch: int) -> int:
    """Round a request batch up to the next power of two (min 1)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    return 1 << (batch - 1).bit_length()


def resolve_leaf(leaf, n: int, dtype, precision: str = "native") -> int:
    """Resolve the ``leaf`` knob (``None`` -> the built-in default; the
    tuning cache of a later slice will be consulted here)."""
    return LEAF_DEFAULT if leaf is None else int(leaf)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    import numpy as np
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 {item})")


def resolve_solve_route(n: int, *, leaf: int | None = None,
                        chunk: int = 256,
                        niter: int | None = None,
                        use_zhat: bool = True,
                        return_boundary: bool = False,
                        tol_factor: float = 8.0,
                        stream_threshold: int | None = None,
                        deflate_budget: int | None = None,
                        resident_threshold: int | None = None,
                        fused: bool = True, dtype=None, device=None,
                        mesh="auto", compress_halo: bool = False,
                        precision: str = "native",
                        refine_tol: float | None = None,
                        certify: bool = False) -> PlanKey:
    """Resolve a full-spectrum request to its bucketed route key -- pure.

    Every request-determined field is concrete (None knobs resolved to
    the defaults of the device's type) and the batch axis unresolved
    (``batch_bucket == 0``).  Knobs of later slices raise
    NotImplementedError naming the ROADMAP item that brings them.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if precision != "native" or refine_tol is not None:
        raise _not_ported("precision='mixed' / refine_tol", "item 7")
    if certify:
        raise _not_ported("certify=True", "item 7")
    if mesh not in ("auto", None, 1) or compress_halo:
        raise _not_ported("sharded solves (mesh, compress_halo)", "item 13")
    if not fused:
        raise NotImplementedError(
            "fused=False (the two-pass baseline) needs the legacy zhat and "
            "boundary-update kernels (ROADMAP Queue 2 rows 5-6)")
    dev = resolve_device(device)
    dtype_name = _dtype_name(torch.float64 if dtype is None else dtype)
    if niter is None:
        niter = (_sec.DEFAULT_NITER_F32 if dtype_name == "float32"
                 else _sec.DEFAULT_NITER)
    leaf = resolve_leaf(leaf, n, dtype_name)
    N, _ = _br._tree_shape(n, leaf)
    if stream_threshold is None:
        stream_threshold = _merge.default_stream_threshold(dev)
    if deflate_budget is None:
        deflate_budget = _merge.DEFAULT_DEFLATE_BUDGET
    if resident_threshold is None:
        resident_threshold = _merge.default_resident_threshold(dev)
    return PlanKey(padded_n=N, leaf=leaf, batch_bucket=0, dtype=dtype_name,
                   chunk=int(chunk), niter=int(niter), use_zhat=use_zhat,
                   return_boundary=return_boundary,
                   tol_factor=float(tol_factor),
                   stream_threshold=int(stream_threshold),
                   deflate_budget=int(deflate_budget),
                   resident_threshold=int(resident_threshold), fused=fused,
                   device=str(dev))


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Static solve schedule for one (padded N, batch bucket) class."""
    key: PlanKey
    levels: int
    # Per-level tuples of the original indices k whose off-diagonal
    # e[k-1] couples each merge at that level.
    coupling_index: tuple
    # Selected-row slots: ("blo", "bhi") (+ "track" with boundary output).
    track_slots: tuple

    @property
    def padded_n(self) -> int:
        return self.key.padded_n

    @property
    def batch_bucket_size(self) -> int:
        return self.key.batch_bucket

    @property
    def device(self) -> torch.device:
        return torch.device(self.key.device)

    @property
    def state_bytes(self) -> int:
        """Persistent-state byte model for one full-bucket launch:
        (3 + r) * N * bucket * itemsize -- inputs, child spectra and the r
        selected rows; the paper's linear-space bound."""
        r = 3 if self.key.return_boundary else 2
        itemsize = torch.empty((), dtype=_torch_dtype(self.key.dtype)
                               ).element_size()
        return (3 + r) * self.key.padded_n * self.key.batch_bucket * itemsize

    def execute(self, d, e, orig_n=None) -> "_br.BRBatchResult":
        """Run the plan on a (B, n) problem batch (B <= bucket, n padding
        to this plan's N).  ``orig_n`` ((B,) original sizes) is the
        mixed-size hook: each problem's boundary row ``orig_n[b] - 1``
        rides the tracked selected-row slot.  Eigenvalues come back
        (B, n); rows of host-padded problems keep the common width.
        """
        key = self.key
        dev = self.device
        dtype = _torch_dtype(key.dtype)
        d, e = _br._as_batch(d, e, dtype, dev)
        B, n = d.shape
        Bb = key.batch_bucket
        if B > Bb:
            raise ValueError(
                f"batch {B} exceeds plan bucket {Bb}; make a bigger plan")
        if _br._tree_shape(n, key.leaf)[0] != key.padded_n:
            raise ValueError(
                f"n={n} pads to {_br._tree_shape(n, key.leaf)[0]}, but this "
                f"plan was built for padded N={key.padded_n}")
        if orig_n is not None:
            orig_n = torch.as_tensor(orig_n, dtype=torch.int64, device=dev)
            if tuple(orig_n.shape) != (B,):
                raise ValueError(
                    f"orig_n must have shape ({B},), got "
                    f"{tuple(orig_n.shape)}")

        if B < Bb:
            # Dummy problems: zero diagonals decouple exactly and cost one
            # deflated pass-through per merge; sliced off below.
            d = torch.cat([d, torch.zeros((Bb - B, n), dtype=dtype,
                                          device=dev)])
            e = torch.cat([e, torch.zeros((Bb - B, max(n - 1, 0)),
                                          dtype=dtype, device=dev)])

        d_pad, e_pad, N, L = _br._pad_problem(d, e, key.leaf)
        # The tracked third row is only needed when padding appends
        # sentinel rows below row n-1 (or per-problem sizes differ).
        if key.return_boundary and orig_n is not None:
            track = torch.cat([orig_n - 1, torch.full(
                (Bb - B,), n - 1, dtype=torch.int64, device=dev)])
        elif key.return_boundary and n != N:
            track = torch.full((Bb,), n - 1, dtype=torch.int64, device=dev)
        else:
            track = None

        lam, rows, kprimes = _br._br_dc_padded_batch(
            d_pad, e_pad, track, leaf=key.leaf, chunk=key.chunk,
            niter=key.niter, use_zhat=key.use_zhat,
            return_boundary=key.return_boundary, tol_factor=key.tol_factor,
            stream_threshold=key.stream_threshold,
            deflate_budget=key.deflate_budget,
            resident_threshold=key.resident_threshold)
        _br.SOLVE_COUNTER.increment()

        if _br.SOLVE_COUNTER.deflation_enabled:
            # Deflation-ratio gauge (opt-in): kprime per level over the
            # merge nodes that touch real data.
            for level, kp in enumerate(kprimes):
                K_level = 2 * key.leaf * (1 << level)
                nm_real = min(kp.shape[1], -(-n // K_level))
                _br.SOLVE_COUNTER.record_deflation(
                    level, float(kp[:B, :nm_real].sum()),
                    B * nm_real * K_level)

        lam = lam[:B, :n]   # sentinels sort above the Gershgorin bound
        if key.return_boundary:
            rows_b = rows[:B]
            blo = rows_b[:, 0, :n]
            bhi = rows_b[:, 2 if track is not None else 1, :n]
        else:
            blo = bhi = None
        return _br.BRBatchResult(lam, blo, bhi,
                                 tuple(k[:B] for k in kprimes))


_PLAN_CACHE: dict[PlanKey, SolvePlan] = {}
_PLAN_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}


def make_plan(n: int, batch: int = 1, *, leaf: int | None = None,
              chunk: int = 256, niter: int | None = None,
              use_zhat: bool = True, return_boundary: bool = False,
              tol_factor: float = 8.0,
              stream_threshold: int | None = None,
              deflate_budget: int | None = None,
              resident_threshold: int | None = None, fused: bool = True,
              dtype=None, device=None, **later) -> SolvePlan:
    """Build (or fetch) the SolvePlan for an (n, batch) request class:
    ``plan_for_route(resolve_solve_route(...), batch)``."""
    route = resolve_solve_route(
        n, leaf=leaf, chunk=chunk, niter=niter, use_zhat=use_zhat,
        return_boundary=return_boundary, tol_factor=tol_factor,
        stream_threshold=stream_threshold, deflate_budget=deflate_budget,
        resident_threshold=resident_threshold, fused=fused, dtype=dtype,
        device=device, **later)
    return plan_for_route(route, batch)


def plan_for_route(route: PlanKey, batch: int = 1) -> SolvePlan:
    """Fix a route key's batch axis and build (or fetch) its SolvePlan."""
    key = route._replace(batch_bucket=batch_bucket(batch))
    N, leaf = key.padded_n, key.leaf
    L = (N // leaf).bit_length() - 1
    with _PLAN_LOCK:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            _STATS["hits"] += 1
            return plan
        _STATS["misses"] += 1
        coupling = []
        for level in range(L):
            M = leaf * (1 << level)
            nm = N // (2 * M)
            coupling.append(tuple((2 * i + 1) * M for i in range(nm)))
        slots = ("blo", "bhi") + (("track",) if key.return_boundary else ())
        plan = SolvePlan(key=key, levels=L, coupling_index=tuple(coupling),
                         track_slots=slots)
        _PLAN_CACHE[key] = plan
        EXECUTOR_TRACES.increment()
        return plan


def plan_cache_stats() -> dict:
    """Plan-cache observability: size, hits, misses, executor builds and
    the summed persistent-state byte model of the cached plans."""
    with _PLAN_LOCK:
        return {"size": len(_PLAN_CACHE), "hits": _STATS["hits"],
                "misses": _STATS["misses"],
                "executor_traces": EXECUTOR_TRACES.count,
                "state_bytes": sum(p.state_bytes
                                   for p in _PLAN_CACHE.values()),
                **_guard.robustness_counters()}


def clear_plan_cache() -> None:
    """Drop cached plans and zero every cache statistic (and the
    robustness counters), so a fresh measurement window starts at zero."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
        EXECUTOR_TRACES.reset()
    _guard.reset_robustness_counters()
