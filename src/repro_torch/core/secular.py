"""Secular equation solver for diagonal-plus-rank-one eigenproblems: the
plain torch versions (port of ``repro.core.secular``).

Solves for the roots of

    g(lam) = 1 + rho * sum_i z2_i / (d_i - lam) = 0

where ``d`` holds ``kprime`` *active* poles sorted ascending in its prefix
(entries at index >= kprime are deflated and carry ``z2 == 0``).  Every
root is represented in the compact delta form ``lam_j = d[origin_j] +
tau_j`` so that denominators ``(d_i - d_origin) - tau`` never suffer
catastrophic cancellation near the pole.

These are the plain versions that stand beside the CUDA kernels of
``repro_torch.kernels``: the CPU path of the port, and the reference the
kernels are held against on the card.  Every function is written for a
leading problem axis ``B`` (the JAX package vmaps its single-problem
functions instead); the single-problem functions are the ``B == 1`` view.
Per-root arithmetic is elementwise in the problem axis, so batched and
single results are bit-identical.

Memory: the chunked paths hold O(B * chunk * K) temporaries, the dense
paths O(B * K^2).
"""

from __future__ import annotations

import torch

# The one secular iteration budget (see ``repro.core.secular`` for the
# accuracy-vs-iterations record): 16 safeguarded middle-way steps, which
# are only sufficient together with the pole-hugging initial guess in
# ``_solve_chunk`` (roots with a tiny-but-undeflated origin weight crawl
# geometrically without it -- the reason LAPACK's DLAED4 carries MAXIT=30).
DEFAULT_NITER = 16

# The f32 budget: single-precision trees reach their accuracy floor by
# ~8-10 steps.
DEFAULT_NITER_F32 = 10


def _pad_len(k: int, chunk: int) -> int:
    return ((k + chunk - 1) // chunk) * chunk


def _take(x, idx):
    """Gather along the last axis: x (B, K), idx (B, C) or (1, C)."""
    return torch.gather(x, -1, idx.expand(x.shape[0], -1))


def _solve_chunk(jc, d, z2, rho, kprime, niter):
    """Solve a chunk of secular roots (safeguarded DLAED4 'middle way').

    jc: (C,) root indices (may exceed K-1 for tail padding), shared by
    every problem.  d, z2: (B, K) poles (active prefix sorted ascending)
    and squared weights (zero at deflated entries); rho: (B,);
    kprime: (B,) integer.  Returns (origin (B, C) int32, tau (B, C)).
    """
    B, K = d.shape
    dtype = d.dtype
    dev = d.device
    jc = jc.to(dev, torch.int64)[None, :]                   # (1, C)
    kp = kprime.to(dev, torch.int64)[:, None]               # (B, 1)
    rho1 = rho[:, None]                                     # (B, 1)
    jc_safe = jc.clamp(max=K - 1)
    active_root = jc < kp                                   # (B, C)
    is_last = jc == (kp - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    sum_z2 = z2.sum(-1, keepdim=True)
    span = rho1 * sum_z2                    # upper bound on lam_max - d_max

    d_j = _take(d, jc_safe)
    jnext = (jc_safe + 1).clamp(max=K - 1)
    d_next_pole = _take(d, jnext)
    # Right end of the gap: next active pole, or d_j + span for the last root.
    gap_hi = torch.where(is_last, d_j + span, d_next_pole)
    mid_lam = 0.5 * (d_j + gap_hi)

    idxK = torch.arange(K, device=dev)
    active_mask = (idxK[None, :] < kp)[:, None, :]          # (B, 1, K)

    # f(mid) decides which gap endpoint becomes the origin pole and gives
    # the first bracket halving for free.
    delta_mid = d[:, None, :] - mid_lam[:, :, None]
    safe = torch.where(active_mask & (delta_mid != 0.0), delta_mid, one)
    w = torch.where(active_mask, z2[:, None, :], zero)
    f_mid = 1.0 + rho1 * torch.sum(w / safe, dim=-1)

    use_left = (f_mid > 0.0) | is_last
    origin = torch.where(use_left, jc_safe, jnext)          # (B, C) int64
    d_org = _take(d, origin)
    tau_mid = mid_lam - d_org

    # Bracket in tau (relative to the origin pole), refined by f(mid).
    last_neg = is_last & (f_mid <= 0.0)
    lo = torch.where(use_left, zero, tau_mid)
    hi = torch.where(use_left, torch.where(last_neg, span, tau_mid), zero)
    lo = torch.where(last_neg, tau_mid, lo)

    # Near poles: gap endpoints for interior roots; for the last root the
    # origin pole and its lower neighbour (LAPACK DLAED4's I=N branch).
    n_lo = torch.where(is_last, (jc_safe - 1).clamp(min=0), jc_safe)
    n_hi = torch.where(is_last, jc_safe, jnext)
    p_lo = _take(d, n_lo) - d_org
    p_hi = _take(d, n_hi) - d_org
    # Derivative side split: poles with index <= n_lo attach to p_lo.
    side_lo = (idxK[None, None, :] <= n_lo[:, :, None]) & active_mask

    d_shift = d[:, None, :] - d_org[:, :, None]             # (B, C, K)

    # ---- pole-hugging guess (origin-dominant 3-term model) -------------
    # r0 + r0' tau - rho z2_org / tau = 0 with r linearized at the origin
    # pole (see repro.core.secular._solve_chunk for the derivation); only
    # preferred when it lands farther from the pole than the quadratic
    # guess and inside the bracket.
    mask_rest = (active_mask
                 & (idxK[None, None, :] != origin[:, :, None])
                 & (d_shift != 0.0))
    dsafe = torch.where(mask_rest, d_shift, one)
    terms0 = torch.where(mask_rest, z2[:, None, :] / dsafe, zero)
    r0 = 1.0 + rho1 * torch.sum(terms0, dim=-1)
    rp0 = rho1 * torch.sum(terms0 / dsafe, dim=-1)
    c_org = rho1 * _take(z2, origin.clamp(max=K - 1))
    sq_h = torch.sqrt(torch.maximum(r0 * r0 + 4.0 * rp0 * c_org, zero))
    tau_m = (torch.where(use_left, -r0 + sq_h, -(r0 + sq_h))
             / torch.where(rp0 > 0.0, 2.0 * rp0, one))
    valid_m = (rp0 > 0.0) & torch.isfinite(tau_m)

    # ---- initial guess: value-matching 2-pole quadratic at tau_mid -----
    A_lo = rho1 * _take(z2, n_lo)
    A_hi = rho1 * _take(z2, n_hi)
    c0 = f_mid - A_lo / (p_lo - tau_mid) - A_hi / (p_hi - tau_mid)
    qb = -(c0 * (p_lo + p_hi) + A_lo + A_hi)
    qc = c0 * p_lo * p_hi + A_lo * p_hi + A_hi * p_lo
    disc0 = torch.maximum(qb * qb - 4.0 * c0 * qc, zero)
    sq0 = torch.sqrt(disc0)
    qq0 = -0.5 * (qb + torch.where(qb >= 0.0, one, -one) * sq0)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    g1 = qq0 / torch.where(c0 == 0.0, one, c0)
    g2 = qc / torch.where(qq0 == 0.0, one, qq0)
    g1 = torch.where(c0 != 0.0, g1, inf)
    g2 = torch.where(qq0 != 0.0, g2, inf)
    in1 = torch.isfinite(g1) & (g1 > lo) & (g1 < hi)
    in2 = torch.isfinite(g2) & (g2 > lo) & (g2 < hi)
    tau0 = torch.where(in1, g1, torch.where(in2, g2, 0.5 * (lo + hi)))
    use_m = (valid_m & (tau_m > lo) & (tau_m < hi)
             & (tau_m.abs() > tau0.abs()))
    tau0 = torch.where(use_m, tau_m, tau0)

    # ---- cluster-lumped pole-hugging guess (port fix) -------------------
    # The guess above linearizes every pole but the origin.  When the
    # origin pole has an undeflated near-duplicate neighbour (closer than
    # the root itself -- glued Wilkinson spectra carry such pairs 1e-13
    # apart), that neighbour's term dominates r0 and r0', the guess lands
    # on the pair's scale instead of the root's, and the safeguarded steps
    # crawl by halving: 16 steps leave roots wrong by ~1e-8 (the JAX
    # package shows the same fault; ROADMAP Queue 3).  Lumping every pole
    # within |tau_m| of the origin into the pole term c (they act as one
    # pole on the root's scale) and solving the same model once more puts
    # such roots on their own magnitude; the result is preferred under the
    # same rule as tau_m.
    near = active_mask & (d_shift.abs() <= tau_m.abs()[:, :, None])
    rest = active_mask & ~near & (d_shift != 0.0)
    dsafe_b = torch.where(rest, d_shift, one)
    terms_b = torch.where(rest, z2[:, None, :] / dsafe_b, zero)
    r0b = 1.0 + rho1 * torch.sum(terms_b, dim=-1)
    rp0b = rho1 * torch.sum(terms_b / dsafe_b, dim=-1)
    c_b = rho1 * torch.sum(torch.where(near, z2[:, None, :], zero), dim=-1)
    sq_b = torch.sqrt(torch.maximum(r0b * r0b + 4.0 * rp0b * c_b, zero))
    tau_b = (torch.where(use_left, -r0b + sq_b, -(r0b + sq_b))
             / torch.where(rp0b > 0.0, 2.0 * rp0b, one))
    use_b = ((rp0b > 0.0) & torch.isfinite(tau_b) & (tau_b > lo)
             & (tau_b < hi) & (tau_b.abs() > tau0.abs()))
    tau0 = torch.where(use_b, tau_b, tau0)

    tiny = torch.full((), torch.finfo(dtype).tiny, dtype=dtype, device=dev)
    w_act = w                                               # (B, 1, K)

    def eval_g(tau):
        delta = d_shift - tau[:, :, None]
        safe = torch.where(active_mask & (delta != 0.0), delta, one)
        g = 1.0 + rho1 * torch.sum(w_act / safe, dim=-1)
        return g, w_act / (safe * safe)

    # ---- safeguarded middle-way iteration (DLAED4) ---------------------
    tau = tau0
    best_tau = tau0
    best_g = torch.full_like(tau0, float("inf"))
    for _ in range(niter):
        g, dterms = eval_g(tau)
        w_lo = rho1 * torch.sum(torch.where(side_lo, dterms, zero), dim=-1)
        w_hi = rho1 * torch.sum(torch.where(~side_lo, dterms, zero), dim=-1)
        gp = w_lo + w_hi

        better = g.abs() < best_g
        best_tau = torch.where(better, tau, best_tau)
        best_g = torch.where(better, g.abs(), best_g)

        hi = torch.where(g > 0.0, tau, hi)
        lo = torch.where(g <= 0.0, tau, lo)

        D_lo = p_lo - tau
        D_hi = p_hi - tau
        C = g - D_lo * w_lo - D_hi * w_hi
        A = (D_lo + D_hi) * g - D_lo * D_hi * gp
        Bq = D_lo * D_hi * g
        disc = torch.maximum(A * A - 4.0 * Bq * C, zero)
        sq = torch.sqrt(disc)
        eta_neg = (A - sq) / torch.where(C == 0.0, one, 2.0 * C)
        eta_pos = 2.0 * Bq / torch.where(A + sq == 0.0, one, A + sq)
        eta = torch.where(A <= 0.0, eta_neg, eta_pos)
        eta_lin = Bq / torch.where(A == 0.0, one, A)
        newton = -g / torch.maximum(gp, tiny)
        eta = torch.where(C == 0.0, torch.where(A != 0.0, eta_lin, newton),
                          eta)
        # eta must move against the sign of g (g increasing in tau).
        eta = torch.where(g * eta >= 0.0, newton, eta)

        cand = tau + eta
        inb = torch.isfinite(cand) & (cand > lo) & (cand < hi)
        tau_next = torch.where(inb, cand, 0.5 * (lo + hi))
        # Freeze once converged exactly.
        tau = torch.where(g == 0.0, tau, tau_next)
    # Final evaluation so the last tau competes with the best seen.
    g_fin, _ = eval_g(tau)
    tau = torch.where(g_fin.abs() < best_g, tau, best_tau)

    # Exact closed form when only one active pole remains.
    single = active_root & (kp == 1)
    tau = torch.where(single, rho1 * z2[:, :1], tau)
    origin = torch.where(single, torch.zeros_like(origin), origin)

    tau = torch.where(active_root, tau, zero)
    origin = torch.where(active_root, origin, jc_safe.expand_as(origin))
    return origin.to(torch.int32), tau.to(dtype)


def secular_solve_batched(d, z2, rho, kprime, *, niter: int = DEFAULT_NITER,
                          chunk: int = 128, dense: bool = False):
    """All K roots of B independent diag(d) + rho z z^T problems.

    d, z2: (B, K); rho, kprime: (B,).  ``dense`` solves every root in one
    (B, K, K) tile; otherwise roots stream in chunks of ``chunk`` (memory
    O(B * chunk * K)).  Per-root math is elementwise, so the two paths are
    bit-identical.  Returns (origin (B, K) int32, tau (B, K)); eigenvalue
    j is ``d[origin[j]] + tau[j]`` and deflated j get (j, 0).
    """
    B, K = d.shape
    if dense:
        jc = torch.arange(K, device=d.device)
        return _solve_chunk(jc, d, z2, rho, kprime, niter)
    C = min(chunk, K)
    Kp = _pad_len(K, C)
    origins, taus = [], []
    for start in range(0, Kp, C):
        jc = torch.arange(start, start + C, device=d.device)
        o, t = _solve_chunk(jc, d, z2, rho, kprime, niter)
        origins.append(o)
        taus.append(t)
    return (torch.cat(origins, dim=1)[:, :K].contiguous(),
            torch.cat(taus, dim=1)[:, :K].contiguous())


def secular_solve_window_batched(d, z2, rho, kprime, start: int,
                                 nroots: int, *, niter: int = DEFAULT_NITER,
                                 chunk: int = 128, dense: bool = False):
    """Roots ``[start, start + nroots)`` of B problems -- the same window of
    each (the cooperative level's layout): d, z2 (B, K); rho, kprime
    (B,).  The root-sharding primitive of the distributed conquer: each
    shard of a cooperative merge solves its own window
    (``merge.merge_level_coop``).  A root's arithmetic depends only on its
    index and the full pole state, so a window equals the same columns of
    :func:`secular_solve_batched` bit for bit, however either call chunks
    the root axis.  The plain version of the window entry of
    ``csrc/secular_roots.cu``.  Returns (origin (B, nroots) int32, tau
    (B, nroots))."""
    start, nroots = int(start), int(nroots)
    if dense or nroots <= chunk:
        jc = torch.arange(start, start + nroots, device=d.device)
        return _solve_chunk(jc, d, z2, rho, kprime, niter)
    C = min(chunk, nroots)
    origins, taus = [], []
    for lo in range(start, start + _pad_len(nroots, C), C):
        jc = torch.arange(lo, lo + C, device=d.device)
        o, t = _solve_chunk(jc, d, z2, rho, kprime, niter)
        origins.append(o)
        taus.append(t)
    return (torch.cat(origins, dim=1)[:, :nroots].contiguous(),
            torch.cat(taus, dim=1)[:, :nroots].contiguous())


def secular_solve_window(d, z2, rho, kprime, start: int, nroots: int, *,
                         niter: int = DEFAULT_NITER, chunk: int = 128,
                         dense: bool = False):
    """Single-problem view of :func:`secular_solve_window_batched`: d, z2
    (K,); rho, kprime scalars.  Returns (origin (nroots,) int32, tau
    (nroots,))."""
    rho_t = torch.as_tensor(rho, dtype=d.dtype, device=d.device).reshape(1)
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    o, t = secular_solve_window_batched(d[None], z2[None], rho_t, kp_t,
                                        start, nroots, niter=niter,
                                        chunk=chunk, dense=dense)
    return o[0], t[0]


def secular_solve(d, z2, rho, kprime, *, niter: int = DEFAULT_NITER,
                  chunk: int = 128, dense: bool = False):
    """Single-problem view of :func:`secular_solve_batched`: d, z2 (K,);
    rho, kprime scalars.  Returns (origin (K,) int32, tau (K,))."""
    rho_t = torch.as_tensor(rho, dtype=d.dtype, device=d.device).reshape(1)
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    o, t = secular_solve_batched(d[None], z2[None], rho_t, kp_t, niter=niter,
                                 chunk=chunk, dense=dense)
    return o[0], t[0]


def secular_eigenvalues(d, origin, tau):
    """Materialize eigenvalues from the compact delta representation."""
    return torch.gather(d, -1, origin.long()) + tau


def _postpass_tile(ic, d, z, d_org, tau, kprime, rho, use_zhat):
    """One fused (B, C, K) delta tile: rows = poles ``ic``, columns = all
    roots.

    The tile ``lam_diff[c, j] = (d_org_j - d_i) + tau_j`` is formed once
    and serves both the Gu-Eisenstat weight of each tile pole (DLAED3's
    ratio-product form, a plain product over the roots, accumulated in
    float64) and the tile poles' contribution to every root column of the
    row update.

    Returns (zhat_c (B, C), y (B, C, K)) with the *unnormalized* secular
    eigenvector entries y_j(i) = w_i / ((d_i - d_org_j) - tau_j).
    """
    B, K = d.shape
    dev = d.device
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    one = torch.ones((), dtype=d.dtype, device=dev)
    kp = kprime.to(dev, torch.int64)[:, None]
    idxK = torch.arange(K, device=dev)
    active_j = (idxK[None, :] < kp)[:, None, :]             # (B, 1, K)

    ic = ic.to(dev, torch.int64)
    ic_safe = ic.clamp(max=K - 1)[None, :]                  # (1, C)
    # valid poles: active AND not tail padding (ic >= K implies >= kprime).
    valid_i = ic[None, :] < kp                              # (B, C)
    d_i = _take(d, ic_safe)
    z_i = _take(z, ic_safe)

    lam_diff = (d_org[:, None, :] - d_i[:, :, None]) + tau[:, None, :]

    if use_zhat:
        pole_diff = d[:, None, :] - d_i[:, :, None]
        selfmask = idxK[None, None, :] == ic_safe[:, :, None]
        ok = active_j & ~selfmask
        # Every factor enters by magnitude and in float64 whatever the
        # input type (the product of K float32 ratios can leave float32's
        # range).  A magnitude below the type's smallest normal number
        # enters as 1 and is counted (+1 in a numerator, -1 in a
        # denominator), and the product is scaled by tiny**count once:
        # the log-space form's floor (zhat_reconstruct_batched) with the
        # tiny powers gathered, so a zero pole gap (two float64 poles 4e-9
        # apart round to one float32 value) and the zero self term of the
        # root on that pole cancel exactly.  A float64 result with no
        # magnitude below tiny is unchanged bit for bit: |a| / |b| rounds
        # as |a / b|, and the final product is taken in magnitude anyway.
        acc = torch.float64
        tiny = torch.finfo(d.dtype).tiny
        a = lam_diff.abs().to(acc)
        b = pole_diff.abs().to(acc)
        fa, fb = ok & (a < tiny), ok & (b < tiny)
        ratio = torch.where(
            ok, torch.where(fa, 1.0, a) / torch.where(fb, 1.0, b), 1.0)
        prod = torch.prod(ratio, dim=-1)
        self_term = ((_take(d_org, ic_safe) - d_i)
                     + _take(tau, ic_safe)).abs().to(acc)
        fs = self_term < tiny
        floored = fa.sum(-1) - fb.sum(-1) + fs
        z2hat = prod * torch.where(fs, 1.0, self_term) / rho[:, None].to(acc)
        z2hat = torch.where(floored == 0, z2hat,
                            z2hat * torch.pow(tiny, floored.to(acc)))
        zhat_c = torch.sign(z_i) * torch.sqrt(z2hat).to(d.dtype)
        zhat_c = torch.where(valid_i, zhat_c, z_i)
        w = torch.where(valid_i, zhat_c, zero)
    else:
        zhat_c = z_i
        w = torch.where(valid_i, z_i, zero)

    delta = -lam_diff                         # (d_i - d_org_j) - tau_j
    vi = valid_i[:, :, None]
    safe = torch.where(vi & (delta != 0.0), delta, one)
    y = torch.where(vi, w[:, :, None] / safe, zero)
    return zhat_c, y


def secular_postpass_batched(R, d, z, origin, tau, kprime, rho, *,
                             use_zhat: bool = True, chunk: int = 128,
                             dense: bool = False):
    """Fused conquer post-pass: weight reconstruction + selected-row update.

    One sweep over the delta structure ``(d_i - d_org_j) - tau_j``,
    chunked over POLES: a pole chunk's zhat needs only its own tile rows,
    so the weights are final within the tile and immediately weight that
    chunk's contribution to every root column; column norms accumulate
    across chunks and are applied once at the end.

    R: (B, r, K); d, z, origin, tau: (B, K); kprime, rho: (B,).
    Returns (zhat (B, K), rows (B, r, K)).
    """
    B, r, K = R.shape
    dev = d.device
    d_org = torch.gather(d, -1, origin.long().clamp(max=K - 1))
    kp = kprime.to(dev, torch.int64)[:, None]
    active_j = torch.arange(K, device=dev)[None, :] < kp    # (B, K)

    if dense:
        ic = torch.arange(K, device=dev)
        zhat, y = _postpass_tile(ic, d, z, d_org, tau, kprime, rho,
                                 use_zhat)
        cols = torch.bmm(R, y)                              # (B, r, K)
        nrm2 = torch.sum(y * y, dim=1)
    else:
        C = min(chunk, K)
        Kp = _pad_len(K, C)
        cols = torch.zeros((B, r, K), dtype=R.dtype, device=dev)
        nrm2 = torch.zeros((B, K), dtype=d.dtype, device=dev)
        zhats = []
        for start in range(0, Kp, C):
            ic = torch.arange(start, start + C, device=dev)
            zhat_c, y = _postpass_tile(ic, d, z, d_org, tau, kprime, rho,
                                       use_zhat)
            Rc = R[:, :, ic.clamp(max=K - 1)]                 # (B, r, C)
            cols = cols + torch.bmm(Rc, y)
            nrm2 = nrm2 + torch.sum(y * y, dim=1)
            zhats.append(zhat_c)
        zhat = torch.cat(zhats, dim=1)[:, :K]

    nrm = torch.sqrt(nrm2)
    cols = cols / torch.where(nrm > 0.0, nrm, torch.ones_like(nrm))[:, None, :]
    rows = torch.where(active_j[:, None, :], cols, R)
    zhat = torch.where(active_j, zhat, z)
    return zhat.contiguous(), rows.contiguous()


def secular_postpass(R, d, z, origin, tau, kprime, rho, *,
                     use_zhat: bool = True, chunk: int = 128,
                     dense: bool = False):
    """Single-problem view of :func:`secular_postpass_batched`: R (r, K);
    d, z, origin, tau (K,); kprime, rho scalars."""
    rho_t = torch.as_tensor(rho, dtype=d.dtype, device=d.device).reshape(1)
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    zhat, rows = secular_postpass_batched(
        R[None], d[None], z[None], origin[None], tau[None], kp_t, rho_t,
        use_zhat=use_zhat, chunk=chunk, dense=dense)
    return zhat[0], rows[0]


def zhat_reconstruct_batched(d, z, origin, tau, kprime, rho, *,
                             chunk: int = 128):
    """Gu-Eisenstat weights of the two-pass conquer (LAPACK DLAED3), in
    log space: for every active pole i

      zhat_i^2 = prod_j (lam_j - d_i) / [rho * prod_{j != i} (d_j - d_i)]

    over the kprime active roots j, with lam_j - d_i = (d_org_j - d_i) +
    tau_j.  Sums of logs cannot overflow; the differences are formed in
    the input type, their logs and sums in float64 (float32's 24 bits
    would lose a few percent of zhat in a sum of thousands of logs;
    float64 inputs are unaffected).  Chunked over poles: O(B * chunk * K)
    temporaries.

    d, z, origin, tau: (B, K); kprime, rho: (B,).  Returns zhat (B, K);
    inactive entries pass z through.
    """
    B, K = d.shape
    dev = d.device
    acc = torch.float64
    zero = torch.zeros((), dtype=acc, device=dev)
    tiny = torch.finfo(d.dtype).tiny
    kp = kprime.to(dev, torch.int64)[:, None]
    idxK = torch.arange(K, device=dev)
    active = idxK[None, :] < kp                             # (B, K)
    jmask = active[:, None, :]
    d_org = torch.gather(d, -1, origin.long().clamp(max=K - 1))
    C = min(chunk, K)
    parts = []
    for start in range(0, _pad_len(K, C), C):
        ic_safe = torch.arange(start, start + C, device=dev).clamp(
            max=K - 1)[None, :]                             # (1, C)
        d_i = _take(d, ic_safe)[:, :, None]
        lam_diff = (d_org[:, None, :] - d_i) + tau[:, None, :]
        pole_diff = d[:, None, :] - d_i
        selfmask = idxK[None, None, :] == ic_safe[:, :, None]
        log_num = torch.where(jmask, torch.log(lam_diff.abs().clamp(
            min=tiny).to(acc)), zero).sum(-1)
        log_den = torch.where(jmask & ~selfmask, torch.log(
            pole_diff.abs().clamp(min=tiny).to(acc)), zero).sum(-1)
        parts.append(torch.exp(log_num - log_den) / rho[:, None].to(acc))
    z2hat = torch.cat(parts, dim=1)[:, :K]
    zhat = torch.sign(z) * torch.sqrt(z2hat.clamp(min=0.0)).to(d.dtype)
    return torch.where(active, zhat, z).contiguous()


def boundary_rows_update_batched(R, d, z, origin, tau, kprime, *,
                                 chunk: int = 128):
    """Selected-row update of the two-pass conquer, any number of rows:
    R_parent[:, j] = R_child @ y_j for every active root j, with

      y_j(i) = (z_i / ((d_i - d_org_j) - tau_j)) / ||.||

    over the active poles i, chunked over roots (the K x K block Y is
    never formed).  An active pole whose denominator is exactly zero
    contributes z_i (the denominator becomes 1), as in the JAX package's
    XLA path; its Pallas kernel drops that term instead.  Deflated
    columns pass through.

    R: (B, r, K) -- r = 2 or 3 for the boundary rows, r = K for the
    full-vector and lazy baselines; d, z, origin, tau: (B, K); kprime:
    (B,).  Returns rows (B, r, K).
    """
    B, r, K = R.shape
    dev = d.device
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    one = torch.ones((), dtype=d.dtype, device=dev)
    kp = kprime.to(dev, torch.int64)[:, None]
    active = torch.arange(K, device=dev)[None, :] < kp      # (B, K)
    act_i = active[:, None, :]
    d_org = torch.gather(d, -1, origin.long().clamp(max=K - 1))
    C = min(chunk, K)
    parts = []
    for start in range(0, _pad_len(K, C), C):
        jc_safe = torch.arange(start, start + C, device=dev).clamp(
            max=K - 1)[None, :]
        delta = ((d[:, None, :] - _take(d_org, jc_safe)[:, :, None])
                 - _take(tau, jc_safe)[:, :, None])          # (B, C, K)
        safe = torch.where(act_i & (delta != 0.0), delta, one)
        y = torch.where(act_i, z[:, None, :] / safe, zero)
        nrm = torch.sqrt(torch.sum(y * y, dim=-1))
        nrm = torch.where(nrm > 0.0, nrm, one)
        parts.append(torch.bmm(R, y.transpose(1, 2)) / nrm[:, None, :])
    cols = torch.cat(parts, dim=2)[:, :, :K]
    return torch.where(active[:, None, :], cols, R).contiguous()


def zhat_reconstruct(d, z, origin, tau, kprime, rho, *, chunk: int = 128):
    """Single-problem view of :func:`zhat_reconstruct_batched`: d, z,
    origin, tau (K,); kprime, rho scalars."""
    rho_t = torch.as_tensor(rho, dtype=d.dtype, device=d.device).reshape(1)
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    return zhat_reconstruct_batched(d[None], z[None], origin[None],
                                    tau[None], kp_t, rho_t, chunk=chunk)[0]


def boundary_rows_update(R, d, z, origin, tau, kprime, *, chunk: int = 128):
    """Single-problem view of :func:`boundary_rows_update_batched`: R
    (r, K); d, z, origin, tau (K,); kprime scalar."""
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    return boundary_rows_update_batched(R[None], d[None], z[None],
                                        origin[None], tau[None], kp_t,
                                        chunk=chunk)[0]


def secular_merge_resident_batched(d, z, R, rho, kprime, *,
                                   niter: int = DEFAULT_NITER,
                                   use_zhat: bool = True):
    """Single-dispatch merge: dense secular solve + dense fused post-pass.

    d, z: (B, K) (z signed, zero at deflated entries); R: (B, r, K);
    rho, kprime: (B,).  Returns (origin (B, K) int32, tau (B, K),
    zhat (B, K), rows (B, r, K)).  The caller gates on K being at or below
    the residency threshold.
    """
    origin, tau = secular_solve_batched(d, z * z, rho, kprime, niter=niter,
                                        dense=True)
    zhat, rows = secular_postpass_batched(R, d, z, origin, tau, kprime, rho,
                                          use_zhat=use_zhat, dense=True)
    return origin, tau, zhat, rows


def secular_merge_resident(d, z, R, rho, kprime, *,
                           niter: int = DEFAULT_NITER,
                           use_zhat: bool = True):
    """Single-problem view of :func:`secular_merge_resident_batched`."""
    rho_t = torch.as_tensor(rho, dtype=d.dtype, device=d.device).reshape(1)
    kp_t = torch.as_tensor(kprime, device=d.device).reshape(1)
    outs = secular_merge_resident_batched(d[None], z[None], R[None], rho_t,
                                          kp_t, niter=niter,
                                          use_zhat=use_zhat)
    return tuple(o[0] for o in outs)
