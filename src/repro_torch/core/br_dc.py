"""Boundary-row divide-and-conquer driver (paper Algorithm 1), batch-first:
port of ``repro.core.br_dc``.

Level-synchronous bottom-up realization of the recursion: all merges at
the same tree depth, of every problem in the batch, run as one level of
``merge.merge_level`` over the flattened ``B x num_nodes`` lanes.
Persistent eigenvector-derived state per level:

    lam   (B, num_nodes, node_size)      -- child spectra
    rows  (B, num_nodes, r, node_size)   -- selected eigenvector-matrix rows

with r == 2 (blo, bhi) for the plain eigenvalue run and r == 3 when
boundary rows of the full matrix are requested and padding appends
sentinel rows: the third slot tracks the row at *original* index n-1
through the tree (a per-problem index tensor, so mixed original sizes
share one plan).  State is B * O(N).

Both public drivers run through a :class:`repro_torch.core.plan.SolvePlan`.
Tensors live on the plan's device: ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import merge as _merge
from repro_torch.core.instrument import SolveCounter, span
from repro_torch.dist import sharding as _dist

# Device-solve instrumentation: one increment per executor launch (a batch
# of B problems is ONE solve).
SOLVE_COUNTER = SolveCounter("device_solves")


class BRResult(NamedTuple):
    eigenvalues: torch.Tensor       # (n,) ascending
    blo: torch.Tensor | None        # (n,) first row of Q (None in root mode)
    bhi: torch.Tensor | None        # (n,) last row of Q
    kprime_per_level: tuple         # diagnostics: active ranks per level


class BRBatchResult(NamedTuple):
    eigenvalues: torch.Tensor       # (B, n) ascending per problem
    blo: torch.Tensor | None        # (B, n) first rows of Q (None unless asked)
    bhi: torch.Tensor | None        # (B, n) last rows of Q
    kprime_per_level: tuple         # diagnostics: (B, num_merges) per level


def _tree_shape(n: int, leaf: int):
    """Static padded size N = leaf * 2^L with N >= n."""
    nblocks = max(1, math.ceil(n / leaf))
    L = math.ceil(math.log2(nblocks))
    return leaf * (1 << L), L


def _pad_problem(d, e, leaf):
    """Pad a batch to N = leaf * 2^L with decoupled sentinel 1x1 blocks.

    d: (B, n), e: (B, n-1).  Returns (d_pad (B, N), e_pad (B, N), N, L);
    e is padded to length N for uniform split indexing.  Sentinels sit
    above each problem's Gershgorin upper bound, so pads sort to the top
    and deflate exactly.
    """
    B, n = d.shape
    N, L = _tree_shape(n, leaf)
    if N == n:
        return d, torch.nn.functional.pad(e, (0, 1)), N, L
    emax = (e.abs().amax(dim=1) if e.shape[1]
            else torch.zeros((B,), dtype=d.dtype, device=d.device))
    sentinel = d.abs().amax(dim=1) + 2.0 * emax + 1.0
    d_pad = torch.cat([d, sentinel[:, None].expand(B, N - n)], dim=1)
    e_pad = torch.cat([e, torch.zeros((B, N - n + 1), dtype=d.dtype,
                                      device=d.device)], dim=1)
    return d_pad, e_pad, N, L


def _leaf_eigh(d_adj, e_pad, leaf):
    """Every leaf block's full eigendecomposition, one batched dense
    ``torch.linalg.eigh``: d_adj, e_pad (B, N) -> (lam (B, nb, leaf),
    Q (B, nb, leaf, leaf)), eigenvalues ascending."""
    B, N = d_adj.shape
    nb = N // leaf
    T = torch.diag_embed(d_adj.reshape(B, nb, leaf))
    if leaf > 1:
        eb = e_pad[:, :N].reshape(B, nb, leaf)[:, :, : leaf - 1]
        j = torch.arange(leaf - 1, device=d_adj.device)
        T[:, :, j, j + 1] = eb
        T[:, :, j + 1, j] = eb
    return torch.linalg.eigh(T)


def _leaf_solve(d_adj, e_pad, leaf, track_local=None):
    """Batched leaf eigensolves (:func:`_leaf_eigh`) keeping only the
    first/last eigenvector rows, plus the per-problem row at local index
    ``track_local`` ((B,) integer) when given.  d_adj, e_pad: (B, N).
    Returns (lam (B, nb, leaf), rows (B, nb, r, leaf)).
    """
    B, N = d_adj.shape
    nb = N // leaf
    lam, Q = _leaf_eigh(d_adj, e_pad, leaf)
    selected = [Q[:, :, 0, :], Q[:, :, leaf - 1, :]]
    if track_local is not None:
        idx = track_local.long()[:, None, None, None].expand(B, nb, 1, leaf)
        selected.append(torch.gather(Q, 2, idx)[:, :, 0, :])
    return lam, torch.stack(selected, dim=2)   # (B, nb, r, leaf)


def _level_coupling(e_pad, level: int, leaf: int, num_merges: int):
    """(rho, sgn), each (B, num_merges), for every merge at this level:
    merge i joins nodes of size M = leaf * 2^level at original index
    k = (2i+1) * M, coupling strength e[k-1]."""
    M = leaf * (1 << level)
    k = (2 * torch.arange(num_merges, device=e_pad.device) + 1) * M
    beta = e_pad[:, k - 1]
    one = torch.ones((), dtype=e_pad.dtype, device=e_pad.device)
    return beta.abs(), torch.where(beta >= 0.0, one, -one)


def _level_pairs(lam, rows, track, M):
    """Pair adjacent nodes for one level of merges.

    lam: (B, 2*nm, M); rows: (B, 2*nm, r, M); track: (B,) *global* tracked
    row index or None.  Returns (lam_pairs (B, nm, 2, M), z_inner
    (B, nm, 2, M), R (B, nm, r, 2M)).  Parent slots: blo <- [blo_L, 0];
    bhi <- [0, bhi_R]; the tracked row from whichever child spans
    track[b] at this level.
    """
    B = lam.shape[0]
    nm = lam.shape[1] // 2
    r = rows.shape[2]
    lam_pairs = lam.reshape(B, nm, 2, M)
    rows_pairs = rows.reshape(B, nm, 2, r, M)  # (B, merge, child, slot, M)
    z_inner = torch.stack(
        [rows_pairs[:, :, 0, 1, :], rows_pairs[:, :, 1, 0, :]], dim=2)
    zeros = torch.zeros((B, nm, M), dtype=lam.dtype, device=lam.device)
    selected = [
        torch.cat([rows_pairs[:, :, 0, 0, :], zeros], dim=-1),
        torch.cat([zeros, rows_pairs[:, :, 1, 1, :]], dim=-1),
    ]
    if track is not None:
        side = (track // M) % 2                            # (B,)
        left = torch.cat([rows_pairs[:, :, 0, 2, :], zeros], dim=-1)
        right = torch.cat([zeros, rows_pairs[:, :, 1, 2, :]], dim=-1)
        selected.append(torch.where((side == 0)[:, None, None], left, right))
    return lam_pairs, z_inner, torch.stack(selected, dim=2)


def _br_dc_padded_batch(d_pad, e_pad, track, *, leaf, chunk, niter, use_zhat,
                        return_boundary, tol_factor, stream_threshold,
                        deflate_budget, resident_threshold, fused=True):
    """Batch-first padded D&C body.

    d_pad, e_pad: (B, N); track: (B,) per-problem tracked original row
    index, or None.  Returns (lam (B, N), rows (B, r, N), kprimes: list of
    (B, num_merges) per level).
    """
    B, N = d_pad.shape
    L = int(math.log2(N // leaf))
    nb = N // leaf

    with span("repro.leaf"):
        # Pre-subtract every rank-one coupling from the boundary diagonals
        # (each interior leaf boundary is split exactly once in the tree).
        if nb > 1:
            k = leaf * torch.arange(1, nb, device=d_pad.device)
            rho_all = e_pad[:, k - 1].abs()
            sub = torch.zeros_like(d_pad)
            sub[:, k - 1] += rho_all
            sub[:, k] += rho_all
            d_adj = d_pad - sub
        else:
            d_adj = d_pad

        track_local = None if track is None else track % leaf
        lam, rows = _leaf_solve(d_adj, e_pad, leaf, track_local=track_local)
    lam, rows, kprimes = _subtree_levels(
        lam, rows, e_pad, track, leaf, L, root_at_top=not return_boundary,
        niter=niter, chunk=chunk, use_zhat=use_zhat, tol_factor=tol_factor,
        stream_threshold=stream_threshold, deflate_budget=deflate_budget,
        resident_threshold=resident_threshold, fused=fused)
    return lam[:, 0], rows[:, 0], kprimes


def _subtree_levels(lam, rows, e_pad, track, leaf, levels, *, root_at_top,
                    **merge_kw):
    """The first ``levels`` merge levels above the leaves (lam (B, nb,
    leaf), rows (B, nb, r, leaf)), each one ``merge_level_batched`` over
    every node of every problem; the level that leaves one node runs in
    root mode if ``root_at_top``.  Returns (lam, rows, kprimes)."""
    kprimes = []
    for level in range(levels):
        with span("repro.level"):
            nm = lam.shape[1] // 2
            M = lam.shape[2]
            rho, sgn = _level_coupling(e_pad, level, leaf, nm)   # (B, nm)
            lam_pairs, z_inner, R = _level_pairs(lam, rows, track, M)
            res = _merge.merge_level_batched(
                lam_pairs, z_inner, R, rho, sgn,
                root_mode=root_at_top and nm == 1, **merge_kw)
        lam, rows = res.lam, res.rows
        kprimes.append(res.kprime)
    return lam, rows, kprimes


def _br_dc_sharded_batch(d_locs, e_locs, tracks, *, leaf, chunk, niter,
                         use_zhat, return_boundary, tol_factor,
                         stream_threshold, deflate_budget,
                         resident_threshold, fused, compress_halo=False):
    """Distributed-conquer D&C body (port of
    ``repro.core.br_dc._br_dc_sharded_batch``), driven from one process.

    d_locs[p], e_locs[p]: (B, Np) -- shard p's contiguous slice of the
    padded (B, N = shards * Np) problem, on shard p's device; tracks[p]:
    the (B,) *global* tracked row index on that device, or None.  Returns
    per-shard lists of the same (lam (B, N), rows (B, r, N)) as
    :func:`_br_dc_padded_batch`, replicated on every shard's device, and
    the (B, num_merges) kprimes of every level (shard 0's copies).

    Phases (the paper's O(n) conquer state makes every transfer linear):

      1. *Divide*: rank-one coupling pre-subtraction.  Couplings interior
         to a shard are local; a shard-edge coupling lives in the left
         neighbour's last ``e`` slot and arrives by the one-element halo
         (``dist.sharding.halo_from_left``).  The adds are grouped as the
         JAX package groups them (every interior ``k-1`` slot, the right
         edge, every ``k`` slot, the left edge), each group writing
         distinct positions, so ``d_adj`` equals its slice of the
         single-device computation bit for bit.
      2. *Independent subtrees*: leaves and ``log2(Np / leaf)`` merge
         levels on each shard's device, never in root mode.
      3. *Transition*: one all-gather of the O(n) state, each shard's
         eigenvalues and r selected rows (the rows int8-compressed with
         ``compress_halo``).
      4. *Cooperative levels*: ``log2(shards)`` levels of
         :func:`repro_torch.core.merge.merge_level_coop` on the replicated
         state, each shard solving its window of the level's roots.

    No host sync: nothing on the level path reads a tensor back.
    """
    shards = len(d_locs)
    devices = [x.device for x in d_locs]
    B, Np = d_locs[0].shape
    if Np % leaf:
        raise ValueError(
            f"shard width {Np} must be a multiple of leaf={leaf} "
            f"(route resolution guarantees 2^L >= shards)")
    L_loc = int(math.log2(Np // leaf))
    L_coop = int(math.log2(shards))
    nb_loc = Np // leaf
    merge_kw = dict(niter=niter, chunk=chunk, use_zhat=use_zhat,
                    tol_factor=tol_factor, stream_threshold=stream_threshold,
                    deflate_budget=deflate_budget,
                    resident_threshold=resident_threshold, fused=fused)

    # ---- 1. divide: coupling pre-subtraction with the shard-edge halo ---
    edges = [e[:, -1].abs() for e in e_locs]      # right-edge couplings
    from_left = _dist.halo_from_left(edges)       # zeros on shard 0
    lam_locs, rows_locs, kp_locs = [], [], []
    for p in range(shards):
        d_loc, e_loc, track = d_locs[p], e_locs[p], tracks[p]
        sub = torch.zeros_like(d_loc)
        if nb_loc > 1:
            k = leaf * torch.arange(1, nb_loc, device=devices[p])
            rho_int = e_loc[:, k - 1].abs()
            sub[:, k - 1] += rho_int
        # e_loc[:, -1] is zero padding on the last shard, so its edge term
        # vanishes there as the global boundary list ends at N - leaf.
        sub[:, Np - 1] += edges[p]
        if nb_loc > 1:
            sub[:, k] += rho_int
        sub[:, 0] += from_left[p]
        d_adj = d_loc - sub

        # ---- 2. leaves and the shard's own subtree ----------------------
        # Shard origins are multiples of leaf (and of 2M at every subtree
        # level), so leaf-local positions and the level-side parities of
        # _level_pairs match global coordinates.
        lam, rows = _leaf_solve(d_adj, e_loc, leaf, track_local=(
            None if track is None else track % leaf))
        lam, rows, kps = _subtree_levels(lam, rows, e_loc, track, leaf,
                                         L_loc, root_at_top=False,
                                         **merge_kw)
        lam_locs.append(lam[:, 0])
        rows_locs.append(rows[:, 0])
        kp_locs.append(kps)
    # Diagnostics keep the global (B, num_merges) layout: shard-local nodes
    # are contiguous in the global node order.
    kprimes = [_dist.gather_lanes([kps[level] for kps in kp_locs])[0]
               for level in range(L_loc)]

    # ---- 3. the O(n) state all-gather ------------------------------------
    lam, rows = _dist.gather_tree_state(lam_locs, rows_locs,
                                        compress=compress_halo)
    # Shard-edge couplings of the cooperative levels, signed (sgn needs
    # the raw e): one (B,) value a shard.
    e_edges = _dist.gather_lanes([e[:, -1:] for e in e_locs])  # (B, shards)

    # ---- 4. cooperative levels -------------------------------------------
    for _ in range(L_coop):
        nm = lam[0].shape[1] // 2
        M = lam[0].shape[2]

        def pairs(p):
            q = (2 * torch.arange(nm, device=devices[p]) + 1) * (M // Np) - 1
            beta = e_edges[p][:, q]                          # (B, nm)
            one = torch.ones((), dtype=beta.dtype, device=beta.device)
            return ((beta.abs(), torch.where(beta >= 0.0, one, -one))
                    + _level_pairs(lam[p], rows[p], tracks[p], M))
        level = _dist.per_device(devices, pairs)
        rho, sgn, lam_pairs, z_inner, R = (
            [x[i] for x in level] for i in range(5))
        res = _merge.merge_level_coop(
            lam_pairs, z_inner, R, rho, sgn,
            root_mode=(nm == 1) and not return_boundary, **merge_kw)
        lam = [x.lam for x in res]
        rows = [x.rows for x in res]
        kprimes.append(res[0].kprime)

    return [x[:, 0] for x in lam], [x[:, 0] for x in rows], kprimes


def _as_batch(d, e, dtype, device):
    """(B, n) / (B, n-1) tensors of ``dtype`` on ``device`` from numpy
    arrays or tensors."""
    d = torch.as_tensor(d, device=device)
    e = torch.as_tensor(e, device=device)
    if dtype is not None:
        d = d.to(dtype)
        e = e.to(dtype)
    if e.dtype != d.dtype:
        e = e.to(d.dtype)
    if (d.ndim != 2 or e.ndim != 2 or e.shape[0] != d.shape[0]
            or e.shape[1] != max(d.shape[1] - 1, 0)):
        raise ValueError(
            f"batched solve expects d (B, n) and e (B, n-1); "
            f"got {tuple(d.shape)} / {tuple(e.shape)}")
    return d, e


def eigvalsh_tridiagonal_batch(d, e, *, leaf: int | None = None,
                               chunk: int = 256,
                               niter: int | None = None,
                               use_zhat: bool = True,
                               return_boundary: bool = False,
                               tol_factor: float = 8.0,
                               stream_threshold: int | None = None,
                               deflate_budget: int | None = None,
                               resident_threshold: int | None = None,
                               fused: bool = True,
                               dtype=None, device=None, mesh="auto",
                               compress_halo: bool = False,
                               precision: str = "native",
                               refine_tol: float | None = None
                               ) -> BRBatchResult:
    """All eigenvalues of B independent symmetric tridiagonals at once.

    d: (B, n), e: (B, n-1), numpy arrays or tensors.  One plan execution,
    B * O(n) state; runs on ``device`` (default: the CUDA card; pass
    ``device="cpu"`` for the plain torch path).  Knobs as in
    ``repro.core.br_dc.eigvalsh_tridiagonal_batch`` (``mesh``,
    ``compress_halo``, ``precision`` and ``refine_tol`` as in
    :func:`eigvalsh_tridiagonal_br`).  Returns
    BRBatchResult with eigenvalues (B, n) ascending per problem.
    """
    from repro_torch.core import plan as _plan  # deferred: plan imports br_dc
    dev = _plan.resolve_device(device)
    if precision == "mixed" and dtype is None:
        dtype = torch.float64   # mixed certifies / returns in f64
    d, e = _as_batch(d, e, dtype, dev)
    B, n = d.shape
    if n == 1:
        ones = torch.ones((B, 1), dtype=d.dtype, device=dev)
        SOLVE_COUNTER.increment()
        return BRBatchResult(d, ones if return_boundary else None,
                             ones if return_boundary else None, ())
    p = _plan.make_plan(n, B, leaf=leaf, chunk=chunk, niter=niter,
                        use_zhat=use_zhat, return_boundary=return_boundary,
                        tol_factor=tol_factor,
                        stream_threshold=stream_threshold,
                        deflate_budget=deflate_budget,
                        resident_threshold=resident_threshold, fused=fused,
                        dtype=d.dtype, device=dev, mesh=mesh,
                        compress_halo=compress_halo, precision=precision,
                        refine_tol=refine_tol)
    return p.execute(d, e)


def eigvalsh_tridiagonal_br(d, e, *, leaf: int | None = None,
                            chunk: int = 256,
                            niter: int | None = None,
                            use_zhat: bool = True,
                            return_boundary: bool = False,
                            tol_factor: float = 8.0,
                            stream_threshold: int | None = None,
                            deflate_budget: int | None = None,
                            resident_threshold: int | None = None,
                            fused: bool = True,
                            dtype=None, device=None, mesh="auto",
                            compress_halo: bool = False,
                            precision: str = "native",
                            refine_tol: float | None = None) -> BRResult:
    """All eigenvalues of the symmetric tridiagonal (d, e) via boundary-row
    D&C; the batch == 1 bucket of the plan core.  Single (possibly
    padded) leaf trees always return (blo, bhi), as in the JAX package.

    ``precision="mixed"`` runs the whole tree in float32, then certifies
    every eigenvalue with float64 Sturm counts against the original
    (d, e) and polishes only the uncertified ones
    (``bisect.refine_clusters``): float64 output within
    ``refine_tol * eps_f64 * max(1, ||T||_inf)`` (default
    ``bisect.DEFAULT_REFINE_TOL``).  Boundary rows under mixed are
    float32-accurate, cast to float64 and permuted with the eigenvalues.
    A problem with an eigenvalue the refinement cannot certify comes back
    all NaN here; ``eigvalsh_tridiagonal`` re-solves such problems
    natively.

    ``mesh`` routes the distributed conquer: "auto" (the default) shards
    problems whose padded N is at least ``plan.DIST_AUTO_MIN_N`` over the
    largest power-of-two count of visible devices of ``device``'s type
    (one card, or the CPU: no sharding); an int P demands P such devices;
    a ``launch.mesh.SolverMesh`` names its shards' devices, and may name
    one device several times (``make_solver_mesh(4, devices=["cuda:0"] *
    4)``); None or 1 is the single-device path.  ``compress_halo``
    int8-compresses the boundary rows of the sharded path's one
    all-gather (lossy; without it the sharded path equals the
    single-device one bit for bit).  Results come back on ``device``.
    """
    from repro_torch.core import plan as _plan  # deferred: plan imports br_dc
    dev = _plan.resolve_device(device)
    if precision == "mixed" and dtype is None:
        dtype = torch.float64   # mixed certifies / returns in f64
    d, e = _as_batch(torch.as_tensor(d)[None], torch.as_tensor(e)[None],
                     dtype, dev)
    n = d.shape[1]
    if n == 1:
        one = torch.ones((1,), dtype=d.dtype, device=dev)
        SOLVE_COUNTER.increment()
        return BRResult(d[0], one, one, ())
    leaf = _plan.resolve_leaf(leaf, n, d.dtype, precision, dev)
    _, L = _tree_shape(n, leaf)
    p = _plan.make_plan(n, 1, leaf=leaf, chunk=chunk, niter=niter,
                        use_zhat=use_zhat,
                        return_boundary=return_boundary or L == 0,
                        tol_factor=tol_factor,
                        stream_threshold=stream_threshold,
                        deflate_budget=deflate_budget,
                        resident_threshold=resident_threshold, fused=fused,
                        dtype=d.dtype, device=dev, mesh=mesh,
                        compress_halo=compress_halo, precision=precision,
                        refine_tol=refine_tol)
    res = p.execute(d, e)
    blo = None if res.blo is None else res.blo[0]
    bhi = None if res.bhi is None else res.bhi[0]
    return BRResult(res.eigenvalues[0], blo, bhi,
                    tuple(k[0] for k in res.kprime_per_level))


def workspace_model(n: int, leaf: int = 32, chunk: int = 128,
                    itemsize: int = 8, stream_threshold: int = 512,
                    batch: int = 1) -> dict:
    """Analytic auxiliary-workspace model (Table 1 accounting), as in the
    JAX package: B * (3N persistent + max(streamed tile, dense tile) +
    leaf batch) floats."""
    N, _ = _tree_shape(n, leaf)
    persistent = batch * 3 * N * itemsize
    dense_tile = N * min(stream_threshold, N)
    transient = batch * (max(chunk * 2 * N, dense_tile) + N * leaf) * itemsize
    return {
        "persistent_bytes": persistent,
        "transient_bytes": transient,
        "total_bytes": persistent + transient,
        "model": f"B*(3N + (max(2*chunk, min(T,N)) + leaf)*N) floats, "
                 f"N={N}, B={batch}",
    }
