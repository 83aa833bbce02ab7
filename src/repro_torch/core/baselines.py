"""Conventional D&C baselines the paper compares against (Tables 3-4): port
of ``repro.core.baselines``.

Both reuse the *same* merge core as BR (``merge.merge_level``) so that
Theorem 3.3's "same split tree / deflation / secular convention" premise
holds exactly -- the only difference is what eigenvector-derived state
persists across levels:

  * ``full_dc``  -- conventional D&C: propagates the complete eigenvector
    matrix rows through every merge.  Quadratic state; also returns Q.
  * ``lazy_dc``  -- the paper's "internal values-only D&C" baseline
    (LAPACK DLAED0(ICOMPQ=0) + DLAEDA): stores the dense local secular
    transform S_v of every merge (obtained by pushing an identity through
    the merge) and *replays* chains of them to reconstruct the boundary
    rows each parent needs (Fig. 2: r_l = ((r_0 S_1) S_2) ... S_l).
    Quadratic replay state, sum_v K_v^2 ~ 2 n^2 floats.

Both push r = K rows through every merge, more than the fused kernels
take, so their levels run the two-pass conquer (``merge_level``'s
``r > FUSED_MAX_ROWS`` route): on the card, the secular-root, log-space
weight and any-row update kernels.  Their workspace models are
``workspace_model_*``, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import merge as _merge
from repro_torch.core.br_dc import (_leaf_eigh, _leaf_solve,
                                    _level_coupling, _pad_problem,
                                    _tree_shape)
from repro_torch.core.secular import DEFAULT_NITER
from repro_torch.core.tridiag import dense_from_tridiag
from repro_torch.core.tune import resolve_device


def _prepare(d, e, leaf, dtype, device):
    """Single-problem padding and coupling pre-subtraction.  Returns
    (d_adj (N,), e_pad (N,), d, e, n, N, L) on the solve's device, d and
    e cast to ``dtype``."""
    dev = resolve_device(device)
    d = torch.as_tensor(d, device=dev)
    e = torch.as_tensor(e, device=dev)
    if dtype is not None:
        d = d.to(dtype)
        e = e.to(dtype)
    e = e.to(d.dtype)
    n = d.shape[0]
    # The br_dc helpers are batch-first; the baselines are single-problem
    # by design (their whole point is quadratic per-problem state), so
    # wrap/unwrap a singleton batch axis.
    d_pad, e_pad, N, L = _pad_problem(d[None, :], e[None, :], leaf)
    d_pad, e_pad = d_pad[0], e_pad[0]
    if N // leaf > 1:
        k = leaf * torch.arange(1, N // leaf, device=dev)
        rho_all = e_pad[k - 1].abs()
        sub = torch.zeros_like(d_pad)
        sub[k - 1] += rho_all
        sub[k] += rho_all
        d_adj = d_pad - sub
    else:
        d_adj = d_pad
    return d_adj, e_pad, d, e, n, N, L


# ---------------------------------------------------------------------------
# Full-vector D&C (conventional; quadratic by design)
# ---------------------------------------------------------------------------

def _full_dc(d_adj, e_pad, *, leaf, chunk, niter, use_zhat):
    N = d_adj.shape[0]
    L = int(math.log2(N // leaf))
    lam, Q = (x[0] for x in _leaf_eigh(d_adj[None], e_pad[None], leaf))
    for level in range(L):
        B = lam.shape[0] // 2
        M = lam.shape[1]
        rho, sgn = _level_coupling(e_pad[None, :], level, leaf, B)
        Q_pairs = Q.reshape(B, 2, M, M)
        z_inner = torch.stack([Q_pairs[:, 0, M - 1, :], Q_pairs[:, 1, 0, :]],
                              dim=1)
        # Full row set: the block-diagonal Q_L (+) Q_R  -> (B, 2M, 2M)
        R = torch.zeros((B, 2 * M, 2 * M), dtype=lam.dtype,
                        device=lam.device)
        R[:, :M, :M] = Q_pairs[:, 0]
        R[:, M:, M:] = Q_pairs[:, 1]
        del Q, Q_pairs
        res = _merge.merge_level(lam.reshape(B, 2, M), z_inner, R, rho[0],
                                 sgn[0], niter=niter, chunk=chunk,
                                 use_zhat=use_zhat, root_mode=False)
        lam, Q = res.lam, res.rows
    return lam[0], Q[0]


def eig_tridiagonal_full_dc(d, e, *, leaf: int = 32, chunk: int = 128,
                            niter: int = DEFAULT_NITER, use_zhat: bool = True,
                            dtype=None, device=None):
    """Conventional full-eigenvector D&C.  Returns (eigenvalues, Q) as
    tensors on the solve's device (the CUDA card unless ``device="cpu"``)."""
    d_adj, e_pad, d, e, n, N, L = _prepare(d, e, leaf, dtype, device)
    if L == 0:
        A = dense_from_tridiag(d.cpu().numpy(), e.cpu().numpy())
        return torch.linalg.eigh(torch.as_tensor(A, device=d.device))
    lam, Q = _full_dc(d_adj, e_pad, leaf=leaf, chunk=chunk, niter=niter,
                      use_zhat=use_zhat)
    return lam[:n], Q[:n, :n]


def eigvalsh_tridiagonal_full_discard(d, e, **kw):
    """Values-only via conventional D&C: compute Q, discard (Table 4 stand-in
    for cuSOLVER Xstedc compz='N' -- full quadratic workspace, values out)."""
    lam, _ = eig_tridiagonal_full_dc(d, e, **kw)
    return lam


# ---------------------------------------------------------------------------
# Lazy-replay internal values-only D&C (paper's quadratic baseline)
# ---------------------------------------------------------------------------

def _replay_rows(S_levels, leaf_rows, level, leaf, nodes, want_hi):
    """Reconstruct blo/bhi(Q_node) of every node in ``nodes`` at ``level``
    by replaying the stored transforms.

    The first row of Q_node lives in its leftmost leaf, the last row in
    its rightmost leaf.  Walk the stored S chain from that leaf upward,
    r <- [r, 0...] @ S (or [0..., r] @ S), growing 2x per level; the
    nodes' chains run side by side, one ``torch.bmm`` per step.
    """
    num_leaves = 1 << level
    leaf_idx = nodes * num_leaves + (num_leaves - 1 if want_hi else 0)
    r = leaf_rows[leaf_idx]                          # (B, leaf)
    for l in range(level):
        parent = leaf_idx >> (l + 1)
        zeros = torch.zeros_like(r)
        # The rightmost leaf sits in the right child, the leftmost in the
        # left child.
        r = torch.cat([zeros, r] if want_hi else [r, zeros], dim=1)
        r = torch.bmm(r[:, None, :], S_levels[l][parent])[:, 0, :]
    return r


def _lazy_dc(d_adj, e_pad, *, leaf, chunk, niter, use_zhat):
    """Values-only D&C that stores dense local transforms and replays them.

    Persistent per-level state: S_levels[l] has shape (B_l, K_l, K_l) --
    the dense local secular transform of every merge at level l (including
    deflation permutations/rotations), exactly the replayable state DLAEDA
    walks.  Boundary rows for a level-l merge are reconstructed by
    replaying the child-spine chains bottom-up: r <- r @ S (GEMV chain of
    cost c_rep*K^2, the term BR eliminates).
    """
    N = d_adj.shape[0]
    L = int(math.log2(N // leaf))
    lam, Qleaf = (x[0] for x in _leaf_eigh(d_adj[None], e_pad[None], leaf))
    # Leaf boundary rows (kept; they are O(n) and seed every replay chain).
    blo_leaf = Qleaf[:, 0, :]
    bhi_leaf = Qleaf[:, leaf - 1, :]
    del Qleaf
    S_levels = []   # S_levels[l]: (B_l, K_l, K_l) dense local transforms
    for level in range(L):
        B = lam.shape[0] // 2
        M = lam.shape[1]
        rho, sgn = _level_coupling(e_pad[None, :], level, leaf, B)
        left = 2 * torch.arange(B, device=lam.device)
        z_inner = torch.stack(
            [_replay_rows(S_levels, bhi_leaf, level, leaf, left, True),
             _replay_rows(S_levels, blo_leaf, level, leaf, left + 1, False)],
            dim=1)
        # Push an identity through the merge to extract the dense local
        # transform S_v (this is what the lazy path must store).
        eye = torch.eye(2 * M, dtype=lam.dtype, device=lam.device)
        res = _merge.merge_level(lam.reshape(B, 2, M), z_inner,
                                 eye.expand(B, 2 * M, 2 * M), rho[0],
                                 sgn[0], niter=niter, chunk=chunk,
                                 use_zhat=use_zhat, root_mode=False)
        lam = res.lam
        S_levels.append(res.rows)   # (B, 2M, 2M) -- quadratic state
    return lam[0]


def eigvalsh_tridiagonal_lazy(d, e, *, leaf: int = 32, chunk: int = 128,
                              niter: int = DEFAULT_NITER, use_zhat: bool = True,
                              dtype=None, device=None):
    """Internal values-only D&C with lazy replay (quadratic workspace)."""
    d_adj, e_pad, _, _, n, N, L = _prepare(d, e, leaf, dtype, device)
    if L == 0:
        lam, _ = _leaf_solve(d_adj[None, :], e_pad[None, :], N)
        return lam[0, 0][:n]
    return _lazy_dc(d_adj, e_pad, leaf=leaf, chunk=chunk, niter=niter,
                    use_zhat=use_zhat)[:n]


# ---------------------------------------------------------------------------
# Sturm bisection full-spectrum reference (linear workspace, O(n^2) work)
# ---------------------------------------------------------------------------

def eigvalsh_tridiagonal_bisect(d, e, *, maxiter: int | None = None,
                                polish: int | None = None, dtype=None,
                                device=None):
    """All eigenvalues via Sturm-count bisection (DSTEBZ-style reference):
    the full-spectrum case of :func:`repro_torch.core.bisect.
    eigvalsh_tridiagonal_range`.  O(n + k) workspace like BR but
    O(n^2 log eps) work -- an algorithmically independent cross-check (no
    merge tree, no secular equation, no deflation)."""
    from repro_torch.core.bisect import eigvalsh_tridiagonal_range
    n = torch.as_tensor(d).shape[-1]
    return eigvalsh_tridiagonal_range(d, e, select="i", il=0, iu=n - 1,
                                      maxiter=maxiter, polish=polish,
                                      dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Workspace models (paper Table 1 / Section 5.3 accounting)
# ---------------------------------------------------------------------------

def workspace_model_lazy(n: int, leaf: int = 32, itemsize: int = 8) -> dict:
    """sum over levels of B_l * K_l^2 = N * sum K_l ~ 2 N^2 floats."""
    N, L = _tree_shape(n, leaf)
    total = 0
    for l in range(L):
        K = leaf * (1 << (l + 1))
        B = N // K
        total += B * K * K
    return {"persistent_bytes": total * itemsize,
            "model": f"sum B_l*K_l^2 = {total} floats (~2N^2), N={N}"}


def workspace_model_full(n: int, leaf: int = 32, itemsize: int = 8) -> dict:
    N, _ = _tree_shape(n, leaf)
    return {"persistent_bytes": N * N * itemsize,
            "model": f"N^2 floats, N={N}"}


def workspace_model_sterf(n: int, itemsize: int = 8) -> dict:
    return {"persistent_bytes": 2 * n * itemsize, "model": "d,e arrays only"}


def workspace_model_bisect(n: int, k: int | None = None, batch: int = 1,
                           itemsize: int = 8) -> dict:
    """Spectrum slicing: d, e^2 inputs + 3k bracket/pivot lanes per problem.

    No merge tree and no selected rows -- the entire state of a k-slice
    solve is the input pair plus (lo, hi, mid) per requested root, so a
    top-32 slice of n = 4096 carries ~2n + 3k floats per problem.
    """
    k = n if k is None else k
    per_problem = 2 * n + 3 * k
    return {"persistent_bytes": batch * per_problem * itemsize,
            "model": f"B*(2n + 3k) floats, n={n}, k={k}, B={batch}"}
