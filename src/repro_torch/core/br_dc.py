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
from repro_torch.core.instrument import SolveCounter

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

    kprimes = []
    for level in range(L):
        nm = lam.shape[1] // 2
        M = lam.shape[2]
        root = (nm == 1) and not return_boundary
        rho, sgn = _level_coupling(e_pad, level, leaf, nm)   # (B, nm)
        lam_pairs, z_inner, R = _level_pairs(lam, rows, track, M)
        res = _merge.merge_level_batched(
            lam_pairs, z_inner, R, rho, sgn,
            niter=niter, chunk=chunk, use_zhat=use_zhat,
            root_mode=root, tol_factor=tol_factor,
            stream_threshold=stream_threshold,
            deflate_budget=deflate_budget,
            resident_threshold=resident_threshold, fused=fused)
        lam, rows = res.lam, res.rows
        kprimes.append(res.kprime)

    return lam[:, 0], rows[:, 0], kprimes


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
                               dtype=None, device=None,
                               precision: str = "native",
                               refine_tol: float | None = None
                               ) -> BRBatchResult:
    """All eigenvalues of B independent symmetric tridiagonals at once.

    d: (B, n), e: (B, n-1), numpy arrays or tensors.  One plan execution,
    B * O(n) state; runs on ``device`` (default: the CUDA card; pass
    ``device="cpu"`` for the plain torch path).  Knobs as in
    ``repro.core.br_dc.eigvalsh_tridiagonal_batch`` (``precision`` and
    ``refine_tol`` as in :func:`eigvalsh_tridiagonal_br`).  Returns
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
                        dtype=d.dtype, device=dev, precision=precision,
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
                            dtype=None, device=None,
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
    leaf = _plan.resolve_leaf(leaf, n, d.dtype, precision)
    _, L = _tree_shape(n, leaf)
    p = _plan.make_plan(n, 1, leaf=leaf, chunk=chunk, niter=niter,
                        use_zhat=use_zhat,
                        return_boundary=return_boundary or L == 0,
                        tol_factor=tol_factor,
                        stream_threshold=stream_threshold,
                        deflate_budget=deflate_budget,
                        resident_threshold=resident_threshold, fused=fused,
                        dtype=d.dtype, device=dev, precision=precision,
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
