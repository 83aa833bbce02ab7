"""Solver-tree collectives of the distributed conquer: port of the solver
half of ``repro.dist.sharding`` (``halo_from_left``, ``gather_lanes``,
``gather_tree_state``).

The eigensolver's 1-D mesh (``launch.mesh.SolverMesh``) has one axis,
SOLVER_AXIS; shard p owns one contiguous slice of the padded tridiagonal
and lives on the mesh's device p.  The JAX package runs these inside a
``shard_map`` body as ``ppermute`` and ``all_gather``; the port drives
every shard from one process, so a collective takes the per-shard list of
tensors (each on its shard's device) and returns a per-shard list: the
transfers are tensor copies to each shard's device (peer copies between
two cards, none where the devices coincide).  A gathered value is
computed once per distinct device, and shards that share a device share
that tensor.

Because the conquer phase carries only O(n) state (eigenvalues and r
boundary rows), every transfer is linear in the slice: a one-element
halo in the divide step, one all-gather of the per-shard (lam, rows)
state at the subtree->cooperative transition, and the root windows of the
cooperative levels (``core.merge.merge_level_coop``).

The trainer's parameter, batch, cache and activation rules are ROADMAP
Queue 1 item 4's other half.
"""

from __future__ import annotations

import torch

from repro_torch.dist import compression as _comp

SOLVER_AXIS = "shard"


def per_device(devices, make):
    """``[make(p) for p in range(len(devices))]``, calling ``make`` once
    per distinct device (with ``p`` the first shard on it): shards that
    share a device share its result."""
    first = {}
    for p, dev in enumerate(devices):
        first.setdefault(str(dev), p)
    memo = {key: make(p) for key, p in first.items()}
    return [memo[str(dev)] for dev in devices]


def halo_from_left(xs):
    """Shift per-shard values one shard to the right: shard p receives
    shard p-1's value on its own device and shard 0 receives zeros (the
    global problem has no boundary left of shard 0), as the JAX package's
    ``ppermute`` fills it."""
    return [torch.zeros_like(xs[0])] + [
        xs[p - 1].to(xs[p].device) for p in range(1, len(xs))]


def gather_lanes(xs):
    """All-gather per-shard trailing lanes into global order: (B, k) on
    each shard -> (B, P * k) on every shard's device, shard p's lanes in
    columns [p*k, (p+1)*k) -- the global node order of the D&C tree."""
    devices = [x.device for x in xs]
    return per_device(devices, lambda p: torch.cat(
        [x.to(devices[p]) for x in xs], dim=1))


def gather_tree_state(lam_locs, rows_locs, *, compress: bool = False):
    """Gather the O(n) subtree state into the replicated node-major layout.

    lam_locs[p]: (B, Np); rows_locs[p]: (B, r, Np) -- shard p's subtree
    root.  Returns per-shard lists of (lam (B, P, Np), rows (B, P, r,
    Np)), the node axis in shard order.

    With ``compress=True`` the rows travel as an int8 payload and one
    float32 scale per (problem, slot) lane (``compression.quantize_lanes``,
    quantized on the sending shard's device) and come back in the rows'
    dtype; the eigenvalues always travel at full precision -- they seed
    the secular poles, where a quantization step would move every root.
    """
    devices = [x.device for x in lam_locs]
    dtype = rows_locs[0].dtype
    lam_g = per_device(devices, lambda p: torch.stack(
        [x.to(devices[p]) for x in lam_locs], dim=1))
    if compress:
        sent = [_comp.quantize_lanes(x) for x in rows_locs]
        rows_g = per_device(devices, lambda p: torch.stack(
            [_comp.dequantize_lanes(q.to(devices[p]), s.to(devices[p]),
                                    dtype) for q, s in sent], dim=1))
    else:
        rows_g = per_device(devices, lambda p: torch.stack(
            [x.to(devices[p]) for x in rows_locs], dim=1))
    return lam_g, rows_g
