"""One boundary-row D&C merge level (paper Algorithm 1, lines 5-11), port of
``repro.core.merge``.

Given W independent merges (two solved children each: their spectra plus
the boundary rows of their eigenvector matrices, and the rank-one
coupling (rho, s)), produce the parent spectra and the parents' selected
rows:

    z      = [ bhi(Q_L) ; s * blo(Q_R) ]          (Lemma 3.1)
    parent = eig( diag(LamL (+) LamR) + rho z z^T )
    R_new  = R_child @ S_v  via selected-row streaming  (Lemma 3.2)

The merge head (z assembly, pole sort, DLAED2 deflation, compaction) is
plain tensor code vectorised over the W lanes; the deflation chain, the
secular solve and the post-pass go through ``repro_torch.kernels.ops``,
i.e. the CUDA kernels for tensors on the card.

On the card the close-pole chain of a whole level is one kernel launch
(``csrc/deflate_chain.cu``) with no host decision: the level never waits
for the device.  On the CPU :func:`_deflate_level` runs the parallel
head of the JAX package, :func:`_deflate_head`, with two host decisions
in place of its ``lax.switch`` and ``lax.cond``: ``int(cmax)``, the
level's largest count of close-pole rotation candidates, which sets the
length of the restricted rotation chain, and ``bool(missed)``, the exact
post-check that routes the level to the sequential chain.  Those chains
are Python loops over steps, each step vectorised over the W lanes; the
sequential one, :func:`_close_pole_scan`, is the kernel's plain
version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import secular as _sec
from repro_torch.core import tune as _tune
from repro_torch.dist import sharding as _dist
from repro_torch.kernels import ops as _ops


class MergeResult(NamedTuple):
    lam: torch.Tensor      # (W, K) parent eigenvalues, ascending
    rows: torch.Tensor     # (W, r, K) updated selected rows (zeros in root mode)
    kprime: torch.Tensor   # (W,) int32 active secular rank after deflation
    rho_eff: torch.Tensor  # (W,) effective rank-one strength (>= 0)


# Tight budget of the parallel deflation head (see repro.core.merge).
# <= 0 (or >= K) disables the head: always the sequential chain.
DEFAULT_DEFLATE_BUDGET = 64


def _lanes(W, device):
    return torch.arange(W, device=device)


def _deflate_tolerance(d, z, rho_eff, tol_factor):
    """Per-lane DLAED2 threshold, dtype-generic through ``eps``: (W,)."""
    dmax = d.abs().amax(dim=-1)
    return tol_factor * torch.finfo(d.dtype).eps * torch.maximum(dmax,
                                                                 rho_eff)


def _hypot(a, b):
    """hypot(a, b) elementwise, the same bits for an element wherever it
    lies in memory.  On the card ``torch.hypot`` (CUDA's hypot: the chain
    kernel ``csrc/deflate_chain.cu`` is held to it bit for bit).  On the
    CPU, ATen's hypot takes a vectorised path for contiguous blocks and
    scalar ``std::hypot`` for strided or tail elements, and the two part
    by an ulp in some pairs, which would make a lane's chain depend on
    its place in the batch; so there it is m sqrt(1 + (s/m)^2) with m =
    max(|a|, |b|) and s = min(|a|, |b|) (0 where m is 0), each step an
    elementwise IEEE-rounded operation."""
    if a.is_cuda:
        return torch.hypot(a, b)
    a, b = a.abs(), b.abs()
    m = torch.maximum(a, b)
    q = torch.minimum(a, b) / torch.where(m > 0.0, m, torch.ones_like(m))
    return m * torch.sqrt(1.0 + q * q)


def _rotation(pd, pz, d_i, z_i, tol):
    """The DLAED2 close-pair test and Givens rotation of pole i against the
    previous kept pole p, elementwise over lanes.  Returns (close0, c, s_g,
    tau_g, d_p_new, d_i_new) where close0 omits the validity terms the
    callers add."""
    tau_g = _hypot(pz, z_i)
    tau_safe = torch.where(tau_g > 0.0, tau_g, torch.ones_like(tau_g))
    c = z_i / tau_safe          # LAPACK: C = Z(NJ)/TAU
    s_g = -pz / tau_safe        # LAPACK: S = -Z(PJ)/TAU
    t = d_i - pd
    close0 = ((t * c * s_g).abs() <= tol) & (tau_g > 0.0)
    d_p_new = pd * c * c + d_i * s_g * s_g
    d_i_new = pd * s_g * s_g + d_i * c * c
    return close0, c, s_g, tau_g, d_p_new, d_i_new


def _close_pole_scan(d, z, R, small, tol):
    """Sequential close-pole deflation chain (LAPACK DLAED2), all W lanes.

    Walks the sorted poles carrying the last *kept* entry; when the
    current pole is within tolerance of it, applies the Givens rotation
    that zeroes the previous z entry, updates both diagonal values, and
    marks the previous column deflated.  d, z, small: (W, K); R (W, r, K);
    tol (W,).  Returns updated (d, z, R, deflated).
    """
    W, K = d.shape
    lanes = _lanes(W, d.device)
    d, z, R = d.clone(), z.clone(), R.clone()
    defl = small.clone()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    pd = torch.zeros(W, dtype=d.dtype, device=d.device)
    pz = torch.zeros_like(pd)
    pidx = torch.full((W,), -1, dtype=torch.int64, device=d.device)
    pvalid = torch.zeros(W, dtype=torch.bool, device=d.device)
    for i in range(K):
        d_i = d[:, i]
        z_i = z[:, i]
        small_i = small[:, i]
        close0, c, s_g, tau_g, d_p_new, d_i_new = _rotation(pd, pz, d_i, z_i,
                                                            tol)
        close = pvalid & ~small_i & close0

        p = pidx.clamp(min=0)
        col_p = R[lanes, :, p]                              # (W, r)
        col_i = R[:, :, i]
        cc, ss = c[:, None], s_g[:, None]
        new_p = cc * col_p + ss * col_i
        new_i = -ss * col_p + cc * col_i

        # A closing pair never aliases (p < i); a non-closing step writes
        # back the values it read.
        cl = close[:, None]
        d[lanes, p] = torch.where(close, d_p_new, d[lanes, p])
        d[:, i] = torch.where(close, d_i_new, d_i)
        z[lanes, p] = torch.where(close, zero, z[lanes, p])
        z[:, i] = torch.where(close, tau_g, z_i)
        R[lanes, :, p] = torch.where(cl, new_p, col_p)
        R[:, :, i] = torch.where(cl, new_i, col_i)
        defl[lanes, p] = defl[lanes, p] | close

        # Carry the current entry forward as the new "last kept" unless it
        # was z-small deflated (then the previous kept entry persists).
        keep = ~small_i
        pd = torch.where(keep, torch.where(close, d_i_new, d_i), pd)
        pz = torch.where(keep, torch.where(close, tau_g, z_i), pz)
        pidx = torch.where(keep, torch.full_like(pidx, i), pidx)
        pvalid = pvalid | keep
    return d, z, R, defl


def _deflate_candidates(d, z, small, tol):
    """Vectorised close-pair detection over W lanes of sorted poles.

    The sequential chain's "previous kept pole" linkage depends only on
    the z-small mask, so it is an exclusive running maximum; the DLAED2
    closeness test runs for every kept pole against its predecessor in
    one sweep, plus two hops of successor propagation.  Returns
    (candidate mask (W, K) bool, prevkept (W, K) int64, -1 for none).
    """
    W, K = d.shape
    idx = torch.arange(K, device=d.device).expand(W, K)
    kept = ~small
    pkc = torch.cummax(torch.where(kept, idx, torch.full_like(idx, -1)),
                       dim=1).values
    prevkept = torch.cat([torch.full((W, 1), -1, dtype=pkc.dtype,
                                     device=d.device), pkc[:, :-1]], dim=1)
    pk = prevkept.clamp(min=0)
    pz = torch.gather(z, 1, pk)
    pd = torch.gather(d, 1, pk)
    close0 = _rotation(pd, pz, d, z, tol[:, None])[0]
    link = kept & (prevkept >= 0)
    close0 = link & close0
    cand = close0 | (link & torch.gather(close0, 1, pk))
    cand = cand | (link & torch.gather(cand, 1, pk))
    return cand, prevkept


def _deflate_apply(d, z, R, small, tol, prevkept, cand, count, *,
                   steps: int):
    """Exact DLAED2 chain restricted to the compacted candidate list.

    Runs ``steps`` dependent steps, each the verbatim arithmetic of
    :func:`_close_pole_scan`'s step on candidate pole ``i`` against its
    precomputed predecessor ``prevkept[i]``; slots past a lane's own
    candidate ``count`` are no-ops.  ``steps`` is the level's largest
    count, so every lane's list is covered.
    """
    W, K = d.shape
    lanes = _lanes(W, d.device)
    d, z, R = d.clone(), z.clone(), R.clone()
    defl = small.clone()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    idx = torch.arange(K, device=d.device).expand(W, K)
    order = torch.argsort(torch.where(cand, idx, torch.full_like(idx, K)),
                          dim=1, stable=True)
    for slot in range(steps):
        i = order[:, slot]
        valid = slot < count
        j = prevkept[lanes, i]
        js = j.clamp(min=0)
        pd, d_i = d[lanes, js], d[lanes, i]
        pz, z_i = z[lanes, js], z[lanes, i]
        close0, c, s_g, tau_g, d_p_new, d_i_new = _rotation(pd, pz, d_i, z_i,
                                                            tol)
        close = valid & (j >= 0) & ~small[lanes, i] & close0

        col_p = R[lanes, :, js]
        col_i = R[lanes, :, i]
        cc, ss = c[:, None], s_g[:, None]
        cl = close[:, None]
        d[lanes, js] = torch.where(close, d_p_new, pd)
        d[lanes, i] = torch.where(close, d_i_new, d_i)
        z[lanes, js] = torch.where(close, zero, pz)
        z[lanes, i] = torch.where(close, tau_g, z_i)
        R[lanes, :, js] = torch.where(cl, cc * col_p + ss * col_i, col_p)
        R[lanes, :, i] = torch.where(cl, -ss * col_p + cc * col_i, col_i)
        defl[lanes, js] = defl[lanes, js] | close
    return d, z, R, defl


def _deflate_missed(d0, z0, d1, z1, small, tol, prevkept, cand):
    """Exact post-hoc check that no step outside the candidate list would
    have rotated (see ``repro.core.merge._deflate_missed``): (W,) bool."""
    pk = prevkept.clamp(min=0)
    pz = torch.gather(z1, 1, pk)
    pd = torch.gather(d1, 1, pk)
    close = (_rotation(pd, pz, d0, z0, tol[:, None])[0]
             & ~small & (prevkept >= 0))
    return (close & ~cand).any(dim=1)


def _deflate_level(d, z, R, small, tol, *, budget: int):
    """Close-pole deflation for one whole level: (W, K) nodes at once.

    On the card: one launch of the chain kernel
    (``ops.deflate_chain_batched``), no host sync, and ``budget`` is a
    no-op -- the kernel's window scan is the sequential chain, so there
    is nothing to budget (the JAX package calls its budget "a speed knob,
    never a semantics knob").  On the CPU: :func:`_deflate_head`.
    """
    if d.is_cuda:
        return _ops.deflate_chain_batched(d, z, R, small, tol)
    return _deflate_head(d, z, R, small, tol, budget=budget)


def _deflate_head(d, z, R, small, tol, *, budget: int):
    """The parallel head, on tensors of any device: detect, compact, and
    run the exact chain over the candidates only, for ``cmax`` steps (the
    level's largest candidate count; the JAX package pads the chain to a
    budget tier >= cmax with no-op steps).  If the post-check finds a
    missed rotation the level runs the sequential chain instead.  Two host
    syncs: ``int(cmax)`` and ``bool(missed)``.  ``budget <= 0`` (or >= K)
    runs the sequential chain directly.
    """
    W, K = d.shape
    if budget <= 0 or budget >= K:
        # The parallel head cannot shorten the chain: sequential directly.
        return _close_pole_scan(d, z, R, small, tol)
    cand, pk = _deflate_candidates(d, z, small, tol)
    count = cand.sum(dim=1)
    cmax = int(count.max())                                  # host sync 1
    d1, z1, R1, defl1 = _deflate_apply(d, z, R, small, tol, pk, cand, count,
                                       steps=cmax)
    missed = _deflate_missed(d, z, d1, z1, small, tol, pk, cand)
    if bool(missed.any()):                                   # host sync 2
        return _close_pole_scan(d, z, R, small, tol)
    return d1, z1, R1, defl1


def default_stream_threshold(device) -> int:
    """Dense-vs-chunked level dispatch default of ``device``'s type (only
    the plain CPU path has a dense form)."""
    return int(_tune.backend_defaults(torch.device(device).type)
               ["stream_threshold"])


def default_resident_threshold(device) -> int:
    """Residency threshold default of ``device``'s type: levels with K at
    or below it run solve + post-pass as one dispatch (one resident
    kernel launch on the card; 0, i.e. off, on the CPU)."""
    return int(_tune.backend_defaults(torch.device(device).type)
               ["resident_threshold"])


def _sum_rows(x):
    """Row sums of x (W, K) in a fixed pairwise order: each pass adds the
    second half of the columns to the first (an odd last column rides
    along), so a row's sum depends on that row alone.  ``torch.sum`` on a
    CUDA tensor splits a row differently as the number of rows changes,
    which made a batched solve differ from the looped one in the last
    bit."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        pair = x[:, :h] + x[:, h:2 * h]
        x = torch.cat([pair, x[:, 2 * h:]], dim=1) if x.shape[1] % 2 else pair
    return x[:, 0]


def _merge_assemble(dL, dR, zL, zR, R, rho, sgn, tol_factor):
    """Merge prelude over W lanes: z assembly, pole sort, z-small deflation.

    dL, dR, zL, zR: (W, M); R (W, r, 2M); rho, sgn (W,).  Returns
    (d, z, R, small, tol, rho_eff) with poles sorted ascending and the
    z-small entries zeroed.
    """
    d0 = torch.cat([dL, dR], dim=1)
    z0 = torch.cat([zL, sgn[:, None] * zR], dim=1)
    nrm2 = _sum_rows(z0 * z0)
    nrm = torch.sqrt(nrm2)
    z = z0 / torch.where(nrm > 0.0, nrm, torch.ones_like(nrm))[:, None]
    rho_eff = rho * nrm2   # rho * z0 z0^T == rho_eff * z z^T, ||z|| = 1

    p1 = torch.argsort(d0, dim=1, stable=True)
    d = torch.gather(d0, 1, p1)
    z = torch.gather(z, 1, p1)
    R = torch.gather(R, 2, p1[:, None, :].expand_as(R))

    tol = _deflate_tolerance(d, z, rho_eff, tol_factor)
    small = rho_eff[:, None] * z.abs() <= tol[:, None]
    z = torch.where(small, torch.zeros_like(z), z)
    return d, z, R, small, tol, rho_eff


def _merge_compact(d, z, R, deflated):
    """Compaction permutation: active poles first (sorted), deflated after
    (``lexsort((d, deflated))`` as two stable sorts).  Returns (d, z, R,
    kprime)."""
    K = d.shape[1]
    pa = torch.argsort(d, dim=1, stable=True)
    pb = torch.argsort(torch.gather(deflated, 1, pa).to(torch.int8), dim=1,
                       stable=True)
    p2 = torch.gather(pa, 1, pb)
    d = torch.gather(d, 1, p2)
    z = torch.gather(z, 1, p2)
    R = torch.gather(R, 2, p2[:, None, :].expand_as(R))
    kprime = (K - deflated.sum(dim=1)).to(torch.int32)
    return d, z, R, kprime


def _merge_head(lam_pairs, z_inner, R, rho, sgn, *, tol_factor,
                deflate_budget):
    """Everything before the secular solve, for one level of W merges.
    Returns (d, z, Rp, kprime, rho_eff): (W, K), (W, K), (W, r, K), (W,),
    (W,)."""
    d, z, Rp, small, tol, rho_eff = _merge_assemble(
        lam_pairs[:, 0], lam_pairs[:, 1], z_inner[:, 0], z_inner[:, 1], R,
        rho, sgn, tol_factor)
    d, z, Rp, deflated = _deflate_level(d, z, Rp, small, tol,
                                        budget=deflate_budget)
    z = torch.where(deflated, torch.zeros_like(z), z)
    return (*_merge_compact(d, z, Rp, deflated), rho_eff)


def _sort_lanes(lam, rows):
    p3 = torch.argsort(lam, dim=1, stable=True)
    lam = torch.gather(lam, 1, p3)
    if rows is not None:
        rows = torch.gather(rows, 2, p3[:, None, :].expand_as(rows))
    return lam, rows


def merge_level(lam_pairs, z_inner, R, rho, sgn, *,
                niter: int = _sec.DEFAULT_NITER, chunk: int = 256,
                use_zhat: bool = True,
                root_mode: bool = False, tol_factor: float = 8.0,
                stream_threshold: int | None = None,
                deflate_budget: int = DEFAULT_DEFLATE_BUDGET,
                resident_threshold: int | None = None,
                fused: bool = True) -> MergeResult:
    """One tree level of merges, all W solved as one batched sweep.

    lam_pairs: (W, 2, M) child spectra; z_inner: (W, 2, M) = (bhi_L,
    blo_R); R: (W, r, 2M); rho, sgn: (W,).  Knobs as in
    ``repro.core.merge.merge_level``; None thresholds take the defaults
    of the tensors' device type.

    ``fused=False`` runs the legacy two-pass conquer: a streamed secular
    solve (never dense, never resident), then the log-space weights and
    the row update, one launch each for all W lanes on the card.  A level
    whose R has more rows than the fused kernels take (``r >
    FUSED_MAX_ROWS``, i.e. r = K in the full-vector and lazy baselines)
    runs the same two passes whatever ``fused`` says, on either device, so
    the CPU tests run the route the card runs.  (The JAX package sends
    such levels through its fused or resident path; the results agree to
    rounding.)
    """
    K = 2 * lam_pairs.shape[-1]
    dev = lam_pairs.device
    if stream_threshold is None:
        stream_threshold = default_stream_threshold(dev)
    if resident_threshold is None:
        resident_threshold = default_resident_threshold(dev)
    two_pass = not fused or R.shape[1] > _ops.FUSED_MAX_ROWS
    dense = not two_pass and K <= stream_threshold
    dtype = lam_pairs.dtype

    d, z, Rp, kprime, rho_eff = _merge_head(lam_pairs, z_inner, R, rho, sgn,
                                            tol_factor=tol_factor,
                                            deflate_budget=deflate_budget)

    # ---- single-dispatch resident merge (small K, solve + post-pass) ---
    if not two_pass and not root_mode and K <= resident_threshold:
        origin, tau, _, rows = _ops.secular_merge_resident_batched(
            d, z, Rp, rho_eff, kprime, niter=niter, use_zhat=use_zhat)
        lam = torch.gather(d, 1, origin.long()) + tau
        lam, rows = _sort_lanes(lam, rows)
        return MergeResult(lam.to(dtype), rows, kprime, rho_eff)

    # ---- secular root solve (compact delta representation, batched) ---
    origin, tau = _ops.secular_solve_batched(
        d, z * z, rho_eff, kprime, niter=niter, chunk=chunk, dense=dense)
    return _merge_tail(d, z, Rp, kprime, rho_eff, origin, tau,
                       root_mode=root_mode, two_pass=two_pass,
                       use_zhat=use_zhat, chunk=chunk, dense=dense,
                       dtype=dtype)


def _merge_tail(d, z, Rp, kprime, rho_eff, origin, tau, *, root_mode,
                two_pass, use_zhat, chunk, dense, dtype) -> MergeResult:
    """Everything after the secular solve, for W lanes: the eigenvalues
    from the delta representation, the selected-row propagation (skipped
    at the root; the two-pass conquer or the fused post-pass) and the
    final sort."""
    lam = torch.gather(d, 1, origin.long()) + tau
    if root_mode:
        lam, _ = _sort_lanes(lam, None)
        return MergeResult(lam.to(dtype), torch.zeros_like(Rp), kprime,
                           rho_eff)
    if two_pass:
        # Legacy two-pass conquer: the delta structure is streamed twice.
        w = (_ops.zhat_reconstruct_batched(d, z, origin, tau, kprime,
                                           rho_eff, chunk=chunk)
             if use_zhat else z)
        rows = _ops.boundary_rows_update_batched(Rp, d, w, origin, tau,
                                                 kprime, chunk=chunk)
    else:
        _, rows = _ops.secular_postpass_batched(
            Rp, d, z, origin, tau, kprime, rho_eff, use_zhat=use_zhat,
            chunk=chunk, dense=dense)
    lam, rows = _sort_lanes(lam, rows)
    return MergeResult(lam.to(dtype), rows, kprime, rho_eff)


def merge_level_coop(lam_pairs, z_inner, R, rho, sgn, *,
                     niter: int = _sec.DEFAULT_NITER, chunk: int = 256,
                     use_zhat: bool = True, root_mode: bool = False,
                     tol_factor: float = 8.0,
                     stream_threshold: int | None = None,
                     deflate_budget: int = DEFAULT_DEFLATE_BUDGET,
                     resident_threshold: int | None = None,
                     fused: bool = True) -> list[MergeResult]:
    """One *cooperative* tree level of the distributed conquer (port of
    ``repro.core.merge.merge_level_coop``).

    Every argument is a per-shard list of the replicated level state (the
    shape of :func:`merge_level_batched`'s: ``lam_pairs`` (B, nm, 2, M)
    ...), shard p's on the mesh's device p; shards that share a device
    share its tensors (``dist.sharding.per_device``), and the replicated
    work runs once per distinct device.  Returns the per-shard list of
    (B, nm, ...) results, replicated the same way.  Work splits three
    ways:

      * merge head (assembly, deflation chain, compaction): replicated --
        it keeps every device's pole state bit-identical to the
        single-device level's;
      * secular root solve, the level's O(K^2) cost: sharded.  Shard p
        solves root window ``[w * Kw, (w+1) * Kw)`` of merge ``m``, with
        ``m = p // G``, ``w = p % G``, ``G = shards / nm`` windows a merge
        and ``Kw = K / G`` (N / shards roots a shard at every cooperative
        level): on the card one launch of the root-window entry of
        ``csrc/secular_roots.cu``.  The (origin, tau) windows are then
        gathered in shard order, which is global root order;
      * post-pass (fused, or the two-pass zhat and row update) and final
        sort: replicated, the single-device level's own code
        (:func:`_merge_tail`).

    A root's arithmetic depends only on its index and the replicated pole
    state, so the level equals :func:`merge_level_batched` bit for bit.
    Levels small enough for the resident single-launch merge (on the
    card K <= 2048), and levels whose roots do not split evenly, run
    :func:`merge_level_batched` replicated instead, as in the JAX package.
    """
    shards = len(lam_pairs)
    devices = [x.device for x in lam_pairs]
    B, nm, _, M = lam_pairs[0].shape
    K = 2 * M
    r = R[0].shape[2]
    if stream_threshold is None:
        stream_threshold = default_stream_threshold(devices[0])
    if resident_threshold is None:
        resident_threshold = default_resident_threshold(devices[0])
    if shards % nm:
        raise ValueError(
            f"cooperative level expects nm | shards; got nm={nm}, "
            f"shards={shards}")
    G = shards // nm                     # root windows per merge
    two_pass = not fused or r > _ops.FUSED_MAX_ROWS
    kw = dict(niter=niter, chunk=chunk, use_zhat=use_zhat,
              root_mode=root_mode, tol_factor=tol_factor,
              stream_threshold=stream_threshold,
              deflate_budget=deflate_budget,
              resident_threshold=resident_threshold, fused=fused)
    if (not two_pass and not root_mode and K <= resident_threshold) \
            or G <= 1 or K % G:
        return _dist.per_device(devices, lambda p: merge_level_batched(
            lam_pairs[p], z_inner[p], R[p], rho[p], sgn[p], **kw))
    Kw = K // G
    dense = not two_pass and K <= stream_threshold
    dtype = lam_pairs[0].dtype

    # ---- merge head, replicated over the flattened (B * nm) lanes -------
    heads = _dist.per_device(devices, lambda p: _merge_head(
        lam_pairs[p].reshape(B * nm, 2, M), z_inner[p].reshape(B * nm, 2, M),
        R[p].reshape(B * nm, r, K), rho[p].reshape(B * nm),
        sgn[p].reshape(B * nm), tol_factor=tol_factor,
        deflate_budget=deflate_budget))

    # ---- sharded secular solve: each shard's (merge, window) pair --------
    windows = []
    for p in range(shards):
        d, z, _, kprime, rho_eff = heads[p]
        m, w = divmod(p, G)
        z_m = z.reshape(B, nm, K)[:, m]
        windows.append(_ops.secular_solve_window_batched(
            d.reshape(B, nm, K)[:, m], z_m * z_m, rho_eff.reshape(B, nm)[:, m],
            kprime.reshape(B, nm)[:, m], w * Kw, Kw, niter=niter,
            chunk=chunk, dense=dense))

    # ---- window all-gather (shard order is global root order), then the
    # ---- replicated post-pass and sort --------------------------------
    def tail(p):
        d, z, Rp, kprime, rho_eff = heads[p]
        origin, tau = (
            torch.stack([x[i].to(devices[p]) for x in windows])
            .reshape(nm, G, B, Kw).permute(2, 0, 1, 3).reshape(B * nm, K)
            for i in (0, 1))
        res = _merge_tail(d, z, Rp, kprime, rho_eff, origin, tau,
                          root_mode=root_mode, two_pass=two_pass,
                          use_zhat=use_zhat, chunk=chunk, dense=dense,
                          dtype=dtype)
        return MergeResult(res.lam.reshape(B, nm, K),
                           res.rows.reshape(B, nm, r, K),
                           res.kprime.reshape(B, nm),
                           res.rho_eff.reshape(B, nm))
    return _dist.per_device(devices, tail)


def merge_level_batched(lam_pairs, z_inner, R, rho, sgn, **kw):
    """Problem-batched level merge: lam_pairs (B, nm, 2, M); z_inner
    (B, nm, 2, M); R (B, nm, r, 2M); rho, sgn (B, nm).  The problem axis
    is absorbed into the lane axis (one level launch for B problems x nm
    nodes); results are reshaped back to (B, nm, ...)."""
    B, nm, _, M = lam_pairs.shape
    r = R.shape[2]
    res = merge_level(
        lam_pairs.reshape(B * nm, 2, M),
        z_inner.reshape(B * nm, 2, M),
        R.reshape(B * nm, r, 2 * M),
        rho.reshape(B * nm), sgn.reshape(B * nm), **kw)
    K = res.lam.shape[-1]
    return MergeResult(
        res.lam.reshape(B, nm, K),
        res.rows.reshape(B, nm, r, K),
        res.kprime.reshape(B, nm),
        res.rho_eff.reshape(B, nm))
