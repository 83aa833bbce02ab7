"""Batch-first solve plans: static tree shape + bucketed plan cache (port of
``repro.core.plan``: full-spectrum and range plans).

A plan captures everything static about a solve up front: the padded
problem size ``N = leaf * 2^L`` and depth ``L``, the per-level coupling
indices, the selected-row slots, and the batch bucket (request batches
rounded up to the next power of two; short batches are padded with
trivial dummy problems and sliced away).  Plans are cached process-wide
by :class:`PlanKey`, which carries the same knob fields as the JAX
package's key plus the device.

PyTorch runs eagerly, so there is no compiled executable behind a plan:
``EXECUTOR_TRACES`` counts *executor builds*, i.e. first sightings of a
tree's identity -- the analogue of the JAX package's trace counter (a
second same-bucket request builds nothing, and ``certify`` is not part of
the tree's identity).  ``RANGE_EXECUTOR_TRACES`` counts range-plan builds
the same way.  :func:`prewarm` builds the plans (and, on the card, the
kernels) of an expected workload before traffic arrives; :func:`tune`
sweeps the knobs on the device and persists the winners to the tuning
cache (``repro_torch.core.tune``), which the route resolvers consult for
every knob that arrives as ``None``.

Distributed conquer: a route's ``shards`` (with the mesh's devices and
``compress_halo``) is part of its key, so same-mesh traffic shares one
plan and a different shard count is a different plan
(``plan_cache_stats()["mesh_buckets"]``).  A sharded plan runs
``br_dc._br_dc_sharded_batch`` over the shards of a ``SolverMesh``,
driven from this process as the JAX package's ``shard_map`` is.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bisect as _bis
from repro_torch.core import br_dc as _br
from repro_torch.core import guard as _guard
from repro_torch.core import merge as _merge
from repro_torch.core import secular as _sec
from repro_torch.core import tune as _tune
from repro_torch.core.instrument import SolveCounter, span
from repro_torch.core.tune import resolve_device  # noqa: F401 (re-export)
from repro_torch.dist.sharding import per_device
from repro_torch.launch.mesh import SolverMesh, visible_devices
from repro_torch.runtime import faults as _faults

# Built-in leaf block size; ``leaf=None`` resolves to the tuning cache's
# winner for the coordinate (if any) and falls back to this.
LEAF_DEFAULT = 32

# Incremented once per executor build (a tree identity seen first).
EXECUTOR_TRACES = SolveCounter("executor_traces")

# Same contract for the partial-spectrum (range) plans.
RANGE_EXECUTOR_TRACES = SolveCounter("range_executor_traces")


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
    # Distributed conquer: contiguous problem shards on the solver mesh (1:
    # the single-device path), whether the subtree->cooperative all-gather
    # int8-compresses the boundary rows (normalized off at one shard), and
    # the mesh's devices (shard p on mesh_devices[p]; () at one shard).
    # Results come back on ``device``.
    shards: int = 1
    compress_halo: bool = False
    mesh_devices: tuple = ()
    # Mixed-precision pipeline: "mixed" runs the whole tree in float32
    # and then Sturm-certifies / polishes the eigenvalues against the
    # original float64 (d, e) to refine_tol * eps_f64 * ||T||; `dtype`
    # stays the OUTPUT dtype (float64).  Certified native routes carry
    # their certification tolerance in refine_tol; uncertified native
    # routes normalize it to 0.0.
    precision: str = "native"
    refine_tol: float = 0.0
    # Certified solves: the request finalizer runs one extra batched
    # Sturm sweep over the outputs.  Not part of the tree's identity:
    # plan_for_route strips it, so certified and uncertified traffic of
    # equal knobs share one plan.
    certify: bool = False


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


def _tuned_leaf(n: int, dtype_name: str, precision: str, dev):
    """Tuning-cache leaf for a request size on ``dev``'s type, as (leaf,
    came_from_cache).  The coordinate is the padded size under
    ``LEAF_DEFAULT`` (the only tree shape known before the knob
    resolves); the tuner writes its ``leaf`` winner there."""
    N0, _ = _br._tree_shape(n, LEAF_DEFAULT)
    tuned = _tune.lookup("solve", n=N0, dtype=dtype_name,
                         precision=precision, device=dev)
    return int(tuned.get("leaf", LEAF_DEFAULT)), "leaf" in tuned


def resolve_leaf(leaf, n: int, dtype, precision: str = "native",
                 device=None) -> int:
    """Resolve the ``leaf`` knob exactly as ``resolve_solve_route`` does,
    so request routing's single-leaf (L == 0) check agrees with the
    route even when the tuning cache overrides the default."""
    if leaf is not None:
        return int(leaf)
    return _tuned_leaf(n, _dtype_name(dtype), precision,
                       resolve_device(device))[0]


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# Auto-routing floor: padded problems at least this large take the sharded
# path when several devices are visible (the JAX package's crossover).
DIST_AUTO_MIN_N = 16384


def _resolve_shards(mesh, padded_n: int, leaf: int, dev: torch.device):
    """Resolve the ``mesh`` routing knob to (shards, mesh devices).

    ``mesh`` may be None / 1 (single device), "auto" (shard problems of
    padded N >= DIST_AUTO_MIN_N over the largest power-of-two count of
    visible devices of ``dev``'s type, which is 1 on one card and on the
    CPU), an int shard count (that many visible devices of ``dev``'s type),
    or a ``SolverMesh`` (its own devices, which may repeat).  Explicit
    requests validate hard -- a clear error beats a silent single-device
    fallback; "auto" degrades to 1 instead.
    """
    max_shards = padded_n // leaf        # one leaf per shard at minimum
    if mesh is None or (isinstance(mesh, int) and mesh == 1):
        return 1, ()
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', an int shard count, "
                             f"or a SolverMesh; got {mesh!r}")
        if padded_n < DIST_AUTO_MIN_N:
            return 1, ()
        avail = visible_devices(dev.type)
        shards = 1 << (len(avail).bit_length() - 1)   # largest pow2 <= count
        while shards > max_shards:
            shards //= 2
        return (shards, tuple(avail[:shards])) if shards > 1 else (1, ())
    if isinstance(mesh, SolverMesh):
        shards, devices = mesh.shards, mesh.devices
    else:
        shards, devices = int(mesh), None
    if shards < 1:
        raise ValueError(f"mesh shard count must be >= 1, got {shards}")
    if shards == 1:
        return 1, ()
    if shards & (shards - 1):
        raise ValueError(
            f"mesh shard count must be a power of two (the D&C tree pairs "
            f"nodes), got {shards}")
    if devices is None:
        avail = visible_devices(dev.type)
        if shards > len(avail):
            raise ValueError(
                f"mesh={shards} but only {len(avail)} {dev.type} device(s) "
                f"are visible; to run several shards on one device pass "
                f"mesh=make_solver_mesh({shards}, devices=[{str(dev)!r}] * "
                f"{shards})")
        devices = tuple(avail[:shards])
    elif {torch.device(x).type for x in devices} != {dev.type}:
        raise ValueError(f"the mesh's devices {devices} are not all of the "
                         f"solve's device type {dev.type!r}")
    if shards > max_shards:
        raise ValueError(
            f"mesh={shards} needs at least {shards} leaves but padded "
            f"n={padded_n} with leaf={leaf} has {max_shards}; use fewer "
            f"shards or a smaller leaf")
    return shards, tuple(devices)


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

    Every request-determined field is concrete and the batch axis
    unresolved (``batch_bucket == 0``).  Each knob that arrives as None
    resolves to the tuning cache's winner for the route's coordinate on
    the device's type first and to that type's default second; explicit
    knobs always win, so a tuned request and an explicit request with the
    same values resolve to the same key.  ``mesh`` resolves to the route's
    shard count and devices (:func:`_resolve_shards`); ``compress_halo``
    is normalized off at one shard, so it never splits a single-device
    bucket.
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if precision not in ("native", "mixed"):
        raise ValueError(
            f"precision must be 'native' or 'mixed', got {precision!r}")
    if precision == "mixed":
        if dtype is not None and _dtype_name(dtype) != "float64":
            raise ValueError(
                f"precision='mixed' returns float64 eigenvalues; dtype "
                f"must be float64 or None, got {_dtype_name(dtype)} (for a "
                f"pure-f32 solve use dtype=float32 with precision='native')")
        dtype = torch.float64
        refine_tol = float(refine_tol if refine_tol is not None
                           else _bis.DEFAULT_REFINE_TOL)
        if refine_tol <= 0.0:
            raise ValueError(
                f"refine_tol must be positive (eps_f64 * ||T|| units), "
                f"got {refine_tol}")
    else:
        if refine_tol is not None and not certify:
            raise ValueError(
                "refine_tol only applies to precision='mixed' or "
                "certify=True routes")
        refine_tol = (float(refine_tol if refine_tol is not None
                            else _bis.DEFAULT_REFINE_TOL) if certify
                      else 0.0)
        if certify and refine_tol <= 0.0:
            raise ValueError(
                f"refine_tol must be positive (eps * ||T|| units), "
                f"got {refine_tol}")
    dev = resolve_device(device)
    dtype_name = _dtype_name(torch.float64 if dtype is None else dtype)
    if niter is None:
        niter = (_sec.DEFAULT_NITER_F32
                 if dtype_name == "float32" or precision == "mixed"
                 else _sec.DEFAULT_NITER)
    consulted = used_tuned = False
    if leaf is None:
        consulted = True
        leaf, used_tuned = _tuned_leaf(n, dtype_name, precision, dev)
    N, _ = _br._tree_shape(n, leaf)
    shards, mesh_devices = _resolve_shards(mesh, N, leaf, dev)
    if (stream_threshold is None or deflate_budget is None
            or resident_threshold is None):
        consulted = True
        tuned = _tune.lookup("solve", n=N, dtype=dtype_name,
                             precision=precision, shards=shards, device=dev)
        if stream_threshold is None:
            used_tuned |= "stream_threshold" in tuned
            stream_threshold = tuned.get(
                "stream_threshold", _merge.default_stream_threshold(dev))
        if deflate_budget is None:
            used_tuned |= "deflate_budget" in tuned
            deflate_budget = tuned.get("deflate_budget",
                                       _merge.DEFAULT_DEFLATE_BUDGET)
        if resident_threshold is None:
            used_tuned |= "resident_threshold" in tuned
            resident_threshold = tuned.get(
                "resident_threshold", _merge.default_resident_threshold(dev))
    if consulted:
        _tune.note_route(used_tuned)
    return PlanKey(padded_n=N, leaf=leaf, batch_bucket=0, dtype=dtype_name,
                   chunk=int(chunk), niter=int(niter), use_zhat=use_zhat,
                   return_boundary=return_boundary,
                   tol_factor=float(tol_factor),
                   stream_threshold=int(stream_threshold),
                   deflate_budget=int(deflate_budget),
                   resident_threshold=int(resident_threshold), fused=fused,
                   device=str(dev), shards=shards,
                   compress_halo=bool(compress_halo) and shards > 1,
                   mesh_devices=mesh_devices, precision=precision,
                   refine_tol=refine_tol, certify=bool(certify))


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
    def devices(self) -> int:
        """Shard count of the solver mesh this plan runs on (1: the
        single-device path), as the JAX package's ``SolvePlan.devices``."""
        return self.key.shards

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
        with span("repro.stage"):
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
                    f"n={n} pads to {_br._tree_shape(n, key.leaf)[0]}, but "
                    f"this plan was built for padded N={key.padded_n}")
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

            if key.precision == "mixed":
                # The whole tree runs in float32; the float64 (d_pad, e_pad)
                # stay behind for the Sturm certification / polish below.
                d_run, e_run = d_pad.to(torch.float32), e_pad.to(torch.float32)
            else:
                d_run, e_run = d_pad, e_pad

            # Chaos-harness hook: a scheduled launch fault raises here, after
            # input staging and before the tree runs.
            _faults.inject("plan.launch")

            tree_kw = dict(
                leaf=key.leaf, chunk=key.chunk, niter=key.niter,
                use_zhat=key.use_zhat, return_boundary=key.return_boundary,
                tol_factor=key.tol_factor,
                stream_threshold=key.stream_threshold,
                deflate_budget=key.deflate_budget,
                resident_threshold=key.resident_threshold, fused=key.fused)
        if key.shards > 1:
            # Chaos-harness hook: corrupts one staged off-diagonal entry
            # (default: the last, a shard-boundary coupling) -- the "halo
            # delivered a damaged value" scenario.
            e_run = _faults.corrupt_entry("dist.halo", e_run)
            lam, rows, kprimes = _executor_sharded(
                d_run, e_run, track, key.mesh_devices,
                compress_halo=key.compress_halo, **tree_kw)
        else:
            split = _batch_sharding(Bb, dev)
            if split is None:
                lam, rows, kprimes = _br._br_dc_padded_batch(
                    d_run, e_run, track, **tree_kw)
            else:
                lam, rows, kprimes = _executor_split(d_run, e_run, track,
                                                     split, **tree_kw)
        with span("repro.finalize"):
            _br.SOLVE_COUNTER.increment()
            # Chaos-harness hook: NaN-poisons configured eigenvalue rows before
            # the mixed stage (a poisoned mixed solve exercises recovery by
            # refinement, a poisoned native solve the finalizer's ladder).
            lam = _faults.poison_rows("plan.output", lam)

            if _br.SOLVE_COUNTER.deflation_enabled:
                # Deflation-ratio gauge (opt-in): kprime per level over the
                # merge nodes that touch real data.
                for level, kp in enumerate(kprimes):
                    K_level = 2 * key.leaf * (1 << level)
                    nm_real = min(kp.shape[1], -(-n // K_level))
                    _br.SOLVE_COUNTER.record_deflation(
                        level, float(kp[:B, :nm_real].sum()),
                        B * nm_real * K_level)

            lam = lam[:B]
            rows_b = rows[:B] if key.return_boundary else None
            if key.precision == "mixed":
                # Certify the f32 tree's eigenvalues with f64 Sturm counts
                # against the ORIGINAL (d, e) and polish only the misses, on
                # the full padded width (sentinel lanes are decoupled and
                # certify vacuously through nvalid).  The polish can reorder
                # ties: one stable sort restores ascending order and permutes
                # the selected rows identically.
                nvalid = (orig_n if orig_n is not None
                          else torch.full((B,), n, dtype=torch.int32,
                                          device=dev))
                lam_ref, rinfo = _bis.refine_clusters(
                    d_pad[:B], e_pad[:B, : N - 1], lam.to(dtype),
                    nvalid=nvalid, tol_factor=key.refine_tol, sort=False,
                    device=dev)
                failed = rinfo["uncertified"].any(axis=1)
                if failed.any():
                    # A problem with a lane the refine rounds could not certify
                    # has failed, like one with a non-finite lane: every lane
                    # of it comes back NaN, sentinels included (a NaN sorts
                    # above them and the [:n] cut below would drop it), and the
                    # request finalizer re-solves the problem natively.
                    lam_ref[torch.from_numpy(failed).to(dev)] = float("nan")
                lam, order = torch.sort(lam_ref, dim=1, stable=True)
                if rows_b is not None:
                    rows_b = torch.gather(
                        rows_b.to(dtype), 2,
                        order[:, None, :].expand(-1, rows_b.shape[1], -1))
                if _br.SOLVE_COUNTER.refinement_enabled:
                    _br.SOLVE_COUNTER.record_refinement(
                        rinfo["targets"], rinfo["polished"],
                        rinfo["iterations"], rinfo["rounds"])

            lam = lam[:, :n]   # sentinels sort above the Gershgorin bound
            if key.return_boundary:
                blo = rows_b[:, 0, :n]
                bhi = rows_b[:, 2 if track is not None else 1, :n]
            else:
                blo = bhi = None
            return _br.BRBatchResult(lam, blo, bhi,
                                     tuple(k[:B] for k in kprimes))


def _batch_sharding(bucket: int, dev: torch.device):
    """The devices a batched solve's bucket is split over, or None.

    A batched solve is embarrassingly parallel across problems, so the
    bucket is split across the visible devices of ``dev``'s type
    (``launch.mesh.visible_devices``): the largest power of two of them,
    and at most the bucket (a power of two, so the split is even).
    Single-controller, as the distributed conquer is: this process drives
    each device's slice and concatenates the slices in order.  Returns
    None where the split does not apply (one device, or a bucket of one).
    """
    devs = visible_devices(dev.type)
    if len(devs) <= 1:
        return None
    n = 1 << (len(devs).bit_length() - 1)   # largest pow2 <= len(devs)
    n = min(n, bucket)
    if n <= 1:
        return None
    return tuple(devs[:n])


def _executor_split(d_run, e_run, track, devices, **kw):
    """The tree on each device's contiguous slice of the (B, N) batch,
    concatenated in order on the batch's device.  Every problem lane is
    independent, so the result is the unsplit solve's bit for bit."""
    home = d_run.device
    per = d_run.shape[0] // len(devices)
    parts = []
    for i, name in enumerate(devices):
        dev = torch.device(name)
        sl = slice(i * per, (i + 1) * per)
        parts.append(_br._br_dc_padded_batch(
            d_run[sl].to(dev), e_run[sl].to(dev),
            None if track is None else track[sl].to(dev), **kw))
    lam = torch.cat([p[0].to(home) for p in parts])
    rows = torch.cat([p[1].to(home) for p in parts])
    kprimes = [torch.cat([p[2][lvl].to(home) for p in parts])
               for lvl in range(len(parts[0][2]))]
    return lam, rows, kprimes


def _executor_sharded(d_run, e_run, track, mesh_devices, *, compress_halo,
                      **kw):
    """The distributed conquer of a (B, N) batch over the shards on
    ``mesh_devices`` (shard p on ``mesh_devices[p]``): shard p's
    contiguous (B, N / shards) slice of the problem axis goes to its
    device, the shards run ``br_dc._br_dc_sharded_batch``, and shard 0's
    replicated result comes back to the batch's device.  Returns (lam
    (B, N), rows (B, r, N), kprimes)."""
    home = d_run.device
    devices = [torch.device(x) for x in mesh_devices]
    Np = d_run.shape[1] // len(devices)
    d_locs, e_locs = (
        [x[:, p * Np:(p + 1) * Np].to(dev).contiguous()
         for p, dev in enumerate(devices)] for x in (d_run, e_run))
    tracks = per_device(devices, lambda p: None if track is None
                        else track.to(devices[p]))
    lam, rows, kprimes = _br._br_dc_sharded_batch(
        d_locs, e_locs, tracks, compress_halo=compress_halo, **kw)
    return (lam[0].to(home), rows[0].to(home),
            [k.to(home) for k in kprimes])


class RangePlanKey(NamedTuple):
    """Bucketed cache key for partial-spectrum (sliced) solves.

    ``k_bucket`` rounds the slice width up to the next power of two and
    the target indices are an input of the launch, so every (il, iu)
    window of one bucketed width shares one plan.  ``select`` is not a
    key field: select-by-value requests resolve to an index window first.
    """
    n: int
    k_bucket: int
    batch_bucket: int
    dtype: str
    maxiter: int
    polish: int
    device: str


@dataclasses.dataclass(frozen=True)
class RangePlan:
    """Static schedule for one (n, k bucket, batch bucket) sliced-solve
    class; ``execute`` is the only entry point that launches work."""
    key: RangePlanKey

    @property
    def k_bucket_size(self) -> int:
        return self.key.k_bucket

    @property
    def device(self) -> torch.device:
        return torch.device(self.key.device)

    @property
    def state_bytes(self) -> int:
        """Persistent-state byte model for one full-bucket launch:
        B * (2n inputs + 4k bracket state (lo, hi, lam, count))."""
        key = self.key
        itemsize = torch.empty((), dtype=_torch_dtype(key.dtype)
                               ).element_size()
        return key.batch_bucket * (2 * key.n + 4 * key.k_bucket) * itemsize

    def execute(self, d, e, il, k: int | None = None):
        """Eigenvalues [il, il + k) of each problem in a (B, n) batch.

        B may be anything <= the plan's batch bucket (short batches pad
        with zero problems) and k anything <= the k bucket (short slices
        clamp their tail targets to n-1: duplicate roots, sliced away).
        ``il`` may be an int or a (B,) integer array: each problem then
        slices its own [il[b], il[b] + k) window in the same launch (the
        ``kind="edges"`` form).  Returns (B, k).
        """
        with span("repro.stage"):
            key = self.key
            dev = self.device
            d, e = _br._as_batch(d, e, _torch_dtype(key.dtype), dev)
            B, n = d.shape
            if n != key.n:
                raise ValueError(
                    f"n={n} but this plan was built for n={key.n}")
            Bb = key.batch_bucket
            if B > Bb:
                raise ValueError(
                    f"batch {B} exceeds plan bucket {Bb}; make a bigger plan")
            k = key.k_bucket if k is None else int(k)
            if not (1 <= k <= key.k_bucket):
                raise ValueError(
                    f"slice width {k} exceeds plan k bucket {key.k_bucket}")
            il = np.asarray(il, np.int64)
            if il.ndim == 0:
                ilv = int(il)
                if not (0 <= ilv and ilv + k <= n):
                    raise ValueError(
                        f"slice [{ilv}, {ilv + k}) out of range for n={n}")
                il = np.full((B,), ilv, np.int64)
            else:
                if il.shape != (B,):
                    raise ValueError(
                        f"per-problem il must have shape ({B},), got "
                        f"{il.shape}")
                if il.min() < 0 or il.max() >= n:
                    raise ValueError(
                        f"per-problem il must lie in [0, {n}); got "
                        f"[{il.min()}, {il.max()}]")

            if B < Bb:
                d = torch.cat([d, torch.zeros((Bb - B, n), dtype=d.dtype,
                                              device=dev)])
                e = torch.cat([e, torch.zeros((Bb - B, max(n - 1, 0)),
                                              dtype=d.dtype, device=dev)])
            il_full = np.zeros((Bb,), np.int64)
            il_full[:B] = il
            targets = np.minimum(il_full[:, None]
                                 + np.arange(key.k_bucket)[None, :], n - 1)
            targets = torch.from_numpy(targets.astype(np.int32)).to(dev)

        lam = _bis._slice_targets(d, e, targets, maxiter=key.maxiter,
                                  polish=key.polish)
        _br.SOLVE_COUNTER.increment()
        return lam[:B, :k]


_PLAN_CACHE: dict[PlanKey, SolvePlan] = {}
_RANGE_CACHE: dict[RangePlanKey, RangePlan] = {}
_PLAN_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0, "range_hits": 0, "range_misses": 0}


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
    """Fix a route key's batch axis and build (or fetch) its SolvePlan.
    The batch bucket is known only here, so this is where the chunk tuned
    for it applies (at most the route's requested chunk).  ``certify``
    (and a native route's certification tolerance) is the request
    finalizer's business, not the tree's: it is stripped here, so
    certified traffic shares the uncertified plan."""
    bucket = batch_bucket(batch)
    tuned_chunk = _tune.lookup(
        "solve", n=route.padded_n, bucket=bucket, dtype=route.dtype,
        precision=route.precision, shards=route.shards,
        device=route.device).get("chunk")
    chunk = (max(8, min(route.chunk, int(tuned_chunk))) if tuned_chunk
             else route.chunk)
    key = route._replace(
        batch_bucket=bucket, chunk=chunk, certify=False,
        refine_tol=route.refine_tol if route.precision == "mixed" else 0.0)
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


def resolve_range_route(n: int, k: int, *, maxiter: int | None = None,
                        polish: int | None = None, dtype=None,
                        device=None) -> RangePlanKey:
    """Resolve a sliced-solve request to its bucketed route key -- pure.
    The batch axis stays unresolved (``batch_bucket == 0``); None knobs
    resolve to the tuning cache's winner for the (n, k bucket, dtype)
    coordinate on the device's type first, the built-in default second."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if not (1 <= k <= n):
        raise ValueError(f"k must be in [1, n]; got k={k}, n={n}")
    dev = resolve_device(device)
    dtype_name = _dtype_name(torch.float64 if dtype is None else dtype)
    k_bucket = min(batch_bucket(k), n)
    if maxiter is None or polish is None:
        tuned = _tune.lookup("range", n=n, dtype=dtype_name, k=k_bucket,
                             device=dev)
        used_tuned = False
        if maxiter is None:
            used_tuned |= "maxiter" in tuned
            maxiter = tuned.get("maxiter", _bis.DEFAULT_MAX_BISECT)
        if polish is None:
            used_tuned |= "polish" in tuned
            polish = tuned.get("polish", _bis.DEFAULT_POLISH)
        _tune.note_route(used_tuned)
    return RangePlanKey(
        n=n, k_bucket=k_bucket, batch_bucket=0, dtype=dtype_name,
        maxiter=int(maxiter), polish=int(polish), device=str(dev))


def make_range_plan(n: int, k: int, batch: int = 1, *,
                    maxiter: int | None = None, polish: int | None = None,
                    dtype=None, device=None) -> RangePlan:
    """Build (or fetch) the RangePlan for an (n, k, batch) sliced request:
    ``range_plan_for_route(resolve_range_route(...), batch)``."""
    return range_plan_for_route(
        resolve_range_route(n, k, maxiter=maxiter, polish=polish,
                            dtype=dtype, device=device), batch)


def range_plan_for_route(route: RangePlanKey,
                         batch: int = 1) -> RangePlan:
    """Fix a range route key's batch axis and build (or fetch) its plan."""
    key = route._replace(batch_bucket=batch_bucket(batch))
    with _PLAN_LOCK:
        plan = _RANGE_CACHE.get(key)
        if plan is not None:
            _STATS["range_hits"] += 1
            return plan
        _STATS["range_misses"] += 1
        plan = RangePlan(key=key)
        _RANGE_CACHE[key] = plan
        RANGE_EXECUTOR_TRACES.increment()
        return plan


def plan_cache_stats() -> dict:
    """Plan-cache observability: size, hits, misses, executor builds and
    the summed persistent-state byte model of the cached plans, for the
    full-spectrum and the range caches, the cached plans by shard count
    (``mesh_buckets``), plus the certify/refine executor
    builds, the tuning provenance (routes resolved on tuned and on
    default knobs, and the cache file's identity) and the robustness
    counters."""
    provenance = _tuning_provenance()
    with _PLAN_LOCK:
        mesh_buckets: dict[int, int] = {}
        for k in _PLAN_CACHE:
            mesh_buckets[k.shards] = mesh_buckets.get(k.shards, 0) + 1
        return {"size": len(_PLAN_CACHE), "hits": _STATS["hits"],
                "misses": _STATS["misses"], "mesh_buckets": mesh_buckets,
                "executor_traces": EXECUTOR_TRACES.count,
                "state_bytes": sum(p.state_bytes
                                   for p in _PLAN_CACHE.values()),
                "range_size": len(_RANGE_CACHE),
                "range_hits": _STATS["range_hits"],
                "range_misses": _STATS["range_misses"],
                "range_executor_traces": RANGE_EXECUTOR_TRACES.count,
                "range_state_bytes": sum(p.state_bytes
                                         for p in _RANGE_CACHE.values()),
                "refine_executor_traces": _bis.REFINE_EXECUTOR_TRACES.count,
                **provenance,
                **_guard.robustness_counters()}


def _tuning_provenance() -> dict:
    ts = _tune.tuning_stats()
    return {"tuned_routes": ts["tuned_routes"],
            "default_routes": ts["default_routes"],
            "tuning_cache": {"path": ts["path"], "entries": ts["entries"],
                             "fingerprint": ts["fingerprint"],
                             "error": ts["error"]}}


def clear_plan_cache() -> None:
    """Drop cached plans and zero every cache statistic, so a fresh
    measurement window starts at zero.  Also clears the robustness
    layer's process-wide state -- the fault schedule and its hit
    counters, the degradation gauge and counters -- so a chaos schedule
    never leaks into the next solve -- and the tuning layer's route
    counters and loaded-cache memo, so the next consult re-reads the file
    (the file itself is untouched)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()
        _RANGE_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
        EXECUTOR_TRACES.reset()
        RANGE_EXECUTOR_TRACES.reset()
        _bis.reset_refine_builds()
    _faults.reset_faults()
    _guard.reset_robustness_counters()
    _br.SOLVE_COUNTER.clear_degradation()
    _tune.reset_consult_stats()
    _tune.reload_tuning_cache()


def tune(workload_spec, **kw) -> dict:
    """Sweep the knob space on the device (``device=``, default the card)
    for a workload and persist the winners to the tuning cache that
    ``resolve_solve_route``, ``resolve_range_route``, ``plan_for_route``
    and the serve scheduler consult.  See
    :func:`repro_torch.core.tune.tune_workload` for the spec format."""
    return _tune.tune_workload(workload_spec, **kw)


def tuning_stats(device=None) -> dict:
    """Tuning-cache observability (file, fingerprint, entry count, and
    tuned/default route counters); see ``repro_torch.core.tune``."""
    return _tune.tuning_stats(device)


# Workload-spec kind aliases accepted by ``prewarm``; "solve" is the
# stacked ("batch") form.  Each resolves through the routing rules its
# real traffic uses ("full" carries the single-problem L == 0
# boundary-rows rule, "slq" always has boundary rows), so the plan built
# is exactly the one the first request needs.
_PREWARM_KIND_ALIASES = {"solve": "batch", "batch": "batch", "full": "full",
                         "slq": "slq"}


def _wait(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def prewarm(workload_spec) -> dict:
    """Build the plans of an expected workload before traffic hits.

    ``workload_spec`` is an iterable of dict entries::

        {"kind": "solve", "n": 1024, "batch": 64, **make_plan knobs}
        {"kind": "full",  "n": 16}                  # single-problem API
        {"kind": "slq",   "n": 64, "batch": 8, "leaf": 8}  # SLQ probes
        {"kind": "range", "n": 4096, "k": 32, "batch": 8, **knobs}
        {"kind": "edges", "n": 16, "k": 1, "batch": 1}   # monitor probes

    An entry may name its ``device`` (default: the card).  Each entry is
    routed exactly like a real request of that kind (``route_request``),
    its plan is built, and one throwaway full-bucket execute on trivial
    problems runs and is waited for.  On the card every kernel source is
    built first (``kernels._build.build_all``, one nvcc each, in
    parallel).  Afterwards the first request of a prewarmed shape adds no
    plan-cache miss and no executor build (``plan_cache_stats()``).
    Boundary-row plans execute with the per-problem ``orig_n`` track
    input, as the serving flush does.  The throwaway solves tick
    SOLVE_COUNTER.  Returns ``{"plans": P, "seconds": s, "traces": t}``.
    """
    from repro_torch.core.request import SolveRequest, route_request
    t0 = time.perf_counter()
    t_start = EXECUTOR_TRACES.count + RANGE_EXECUTOR_TRACES.count
    built = False
    plans = 0
    for spec in workload_spec:
        spec = dict(spec)
        kind = spec.pop("kind", "solve")
        n = int(spec.pop("n"))
        batch = int(spec.pop("batch", 1))
        device = spec.pop("device", None)
        if kind not in _PREWARM_KIND_ALIASES and kind not in ("range",
                                                             "edges"):
            raise ValueError(
                f"unknown prewarm kind {kind!r}; use one of "
                f"{tuple(_PREWARM_KIND_ALIASES) + ('range', 'edges')}")
        dev = resolve_device(device)
        if dev.type == "cuda" and not built:
            from repro_torch.kernels import _build
            _build.build_all(_build.SOURCES)
            built = True
        dtype = np.dtype(_dtype_name(spec.get("dtype") or torch.float64))
        if kind in _PREWARM_KIND_ALIASES:
            req_kind = _PREWARM_KIND_ALIASES[kind]
            d = np.zeros((n,) if req_kind == "full" else (batch, n), dtype)
            e = np.zeros(d.shape[:-1] + (max(n - 1, 0),), dtype)
            routed = route_request(SolveRequest(
                d=d, e=e, kind=req_kind,
                return_boundary=bool(spec.pop("return_boundary", False)),
                certify=bool(spec.pop("certify", False)),
                knobs=spec, device=device))
            if routed.route is not None:   # n == 1 short circuits: no plan
                plan = plan_for_route(routed.route, batch)
                d2 = np.zeros((batch, n), dtype)
                e2 = np.zeros((batch, max(n - 1, 0)), dtype)
                # Serve flushes pass per-problem orig_n (the tracked-row
                # form when boundary rows are on); "full" mirrors the
                # single-problem sync execution instead.
                orig_n = (np.full((batch,), n, np.int64)
                          if plan.key.return_boundary and req_kind != "full"
                          else None)
                plan.execute(d2, e2, orig_n=orig_n)
        elif kind == "range":
            k = int(spec.pop("k"))
            plan = make_range_plan(n, k, batch, device=device, **spec)
            plan.execute(np.zeros((batch, n), dtype),
                         np.zeros((batch, max(n - 1, 0)), dtype), 0, k)
        else:
            # Spectral-monitor probes: routed like a real probe (rows
            # duplicated, per-problem il), so the plan is the range plan
            # at the duplicated-rows batch bucket.
            k = int(spec.pop("k", 1))
            routed = route_request(SolveRequest(
                d=np.zeros((batch, n), dtype),
                e=np.zeros((batch, max(n - 1, 0)), dtype), kind="edges",
                knobs={"k": k, **spec}, device=device))
            plan = range_plan_for_route(routed.route, routed.batch)
            plan.execute(routed.d, routed.e, routed.il, routed.k)
        _wait(dev)
        plans += 1
    return {"plans": plans, "seconds": time.perf_counter() - t0,
            "traces": EXECUTOR_TRACES.count + RANGE_EXECUTOR_TRACES.count
            - t_start}
