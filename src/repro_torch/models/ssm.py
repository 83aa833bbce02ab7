"""Mamba2 (SSD / state-space duality) block, chunked, with O(1) decode
state (port of ``repro.models.ssm``).

Implements the SSD algorithm of arXiv:2405.21060: scalar-identity state
transition per head, chunked into intra-chunk (quadratic within chunk,
attention-like) and inter-chunk (recurrent state passing) parts.

Train/prefill:  y = SSD(x*dt, exp(dt*A), B, C) computed chunk-parallel.
Decode:         S <- a * S + dt * (B (x) x);  y = C . S  -- O(1) per token.

Shapes: heads H, head dim P (H*P = expand*d_model), state N (single group).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Init, _ct, _dt

Params = Dict[str, Any]
_F32 = torch.float32


def _dims(cfg):
    d = cfg.d_model
    dn = cfg.ssm_expand * d
    H = cfg.ssm_num_heads
    P = dn // H
    N = cfg.ssm_state_dim
    return d, dn, H, P, N


def init_mamba2(ini: Init, cfg, lead=()) -> Params:
    d, dn, H, P, N = _dims(cfg)
    conv_dim = dn + 2 * N
    lead = tuple(lead)
    dt = _dt(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64))
    return {
        # in_proj -> [z (dn), x (dn), B (N), C (N), dt (H)]
        "w_in": ini.normal(lead + (d, 2 * dn + 2 * N + H), dt, d ** -0.5),
        "conv_w": ini.normal(lead + (cfg.ssm_conv_width, conv_dim), dt, 0.5),
        "conv_b": ini.full(lead + (conv_dim,), 0.0, dt),
        "A_log": ini.tensor(a_log.expand(lead + (H,)), _F32),
        "dt_bias": ini.full(lead + (H,), 0.0, _F32),
        "D": ini.full(lead + (H,), 1.0, _F32),
        "norm": ini.full(lead + (dn,), 1.0, dt),
        "w_out": ini.normal(lead + (dn, d), dt, dn ** -0.5),
    }


def _split_in(cfg, proj):
    d, dn, H, P, N = _dims(cfg)
    z = proj[..., :dn]
    xbc = proj[..., dn: 2 * dn + 2 * N]
    dt = proj[..., 2 * dn + 2 * N:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, width):
    """Depthwise causal conv over time: xbc (B, L, C)."""
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    L = xbc.shape[1]
    out = sum(pad[:, i: i + L, :] * w[i][None, None, :]
              for i in range(width))
    return F.silu(out + b[None, None, :])


def _gated_norm(y, z, scale, eps):
    yf = y.to(_F32) * F.silu(z.to(_F32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * scale.to(_F32)


def mamba2_forward(p, cfg, x, *, return_state: bool = False):
    """Chunked SSD scan.  x: (B, L, D) -> (B, L, D)."""
    d, dn, H, P, N = _dims(cfg)
    B_, L, _ = x.shape
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    ct = _ct(cfg)

    proj = torch.einsum("bld,de->ble", x, p["w_in"].to(ct))
    z, xbc_pre, dt_raw = _split_in(cfg, proj)
    xbc = _causal_conv(xbc_pre, p["conv_w"].to(ct), p["conv_b"].to(ct),
                       cfg.ssm_conv_width)
    xs = xbc[..., :dn].reshape(B_, L, H, P)
    Bm = xbc[..., dn: dn + N]                                  # (B,L,N)
    Cm = xbc[..., dn + N:]                                     # (B,L,N)

    dt = F.softplus(dt_raw.to(_F32) + p["dt_bias"])            # (B,L,H)
    A = -torch.exp(p["A_log"])                                 # (H,) negative
    # log decay per step: la = dt * A  (<= 0)
    la = dt * A[None, None, :]                                 # (B,L,H)

    # chunk views
    cum = torch.cumsum(la.reshape(B_, nc, Q, H), dim=2)        # (B,nc,Q,H)
    total = cum[:, :, -1, :]                                   # (B,nc,H)
    xdt = (xs.to(_F32) * dt[..., None]).reshape(B_, nc, Q, H, P)
    Bc = Bm.to(_F32).reshape(B_, nc, Q, N)
    Cc = Cm.to(_F32).reshape(B_, nc, Q, N)

    # ---- intra-chunk (attention-like, strictly causal incl. diagonal) ----
    # M[t,s] = exp(cum_t - cum_s) for s <= t.  Mask BEFORE the exp: the
    # discarded (s > t) entries have gap > 0 and exp(gap) overflows, which
    # poisons the backward pass (inf * 0 -> NaN in the where-grad).
    gap = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nc,Q,Q,H)
    it = torch.arange(Q, device=x.device)
    tri = (it[:, None] >= it[None, :])[None, None, :, :, None]
    gap = torch.where(tri, gap, torch.full((), -math.inf, dtype=_F32,
                                           device=x.device))
    Mmat = torch.exp(gap)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (B,nc,Q,Q)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, Mmat, xdt)

    # ---- inter-chunk: local end-states then sequential chunk loop --------
    # local state: S_c = sum_s exp(cum_Q - cum_s) * B_s (x) xdt_s
    wgt = torch.exp(total[:, :, None, :] - cum)                # (B,nc,Q,H)
    S_loc = torch.einsum("bcqh,bcqn,bcqhp->bchnp", wgt, Bc, xdt)
    decay = torch.exp(total)                                   # (B,nc,H)

    S = torch.zeros((B_, H, N, P), dtype=_F32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S_loc[:, c] + decay[:, c, :, None, None] * S
    S_prevs = torch.stack(S_prevs, dim=1)                      # (B,nc,H,N,P)

    # y_inter[t] = exp(cum_t) * C_t . S_prev(chunk)
    y_inter = torch.einsum("bcqh,bcqn,bchnp->bcqhp", torch.exp(cum), Cc,
                           S_prevs)

    y = (y_intra + y_inter).reshape(B_, L, H, P)
    y = y + xs.to(_F32) * p["D"][None, None, :, None]
    y = y.reshape(B_, L, dn)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps).to(ct)
    out = torch.einsum("ble,ed->bld", y, p["w_out"].to(ct))
    if return_state:
        w = cfg.ssm_conv_width
        cache = {"conv": xbc_pre[:, L - (w - 1):, :].to(_F32), "ssm": S}
        return out, cache
    return out


def mamba2_init_cache(cfg, batch: int, dtype=_F32, device=None):
    d, dn, H, P, N = _dims(cfg)
    conv_dim = dn + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=_F32, device=device),
    }


def mamba2_decode(p, cfg, x, cache):
    """One-token recurrent step.  x: (B, 1, D)."""
    d, dn, H, P, N = _dims(cfg)
    B_ = x.shape[0]
    ct = _ct(cfg)
    proj = torch.einsum("bld,de->ble", x, p["w_in"].to(ct))
    z, xbc_new, dt_raw = _split_in(cfg, proj)

    # causal conv over the rolling window
    window = torch.cat([cache["conv"], xbc_new.to(cache["conv"].dtype)],
                       dim=1)                                  # (B, W, C)
    conv_out = (torch.einsum("bwc,wc->bc", window.to(ct), p["conv_w"].to(ct))
                + p["conv_b"].to(ct))
    xbc = F.silu(conv_out)[:, None, :]                         # (B,1,C)
    new_conv = window[:, 1:, :]

    xs = xbc[..., :dn].reshape(B_, H, P)
    Bm = xbc[:, 0, dn: dn + N]
    Cm = xbc[:, 0, dn + N:]

    dt = F.softplus(dt_raw[:, 0].to(_F32) + p["dt_bias"])     # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None, :])                             # (B,H)
    xdt = xs.to(_F32) * dt[..., None]                          # (B,H,P)

    S = (cache["ssm"] * a[:, :, None, None]
         + torch.einsum("bn,bhp->bhnp", Bm.to(_F32), xdt))
    y = torch.einsum("bn,bhnp->bhp", Cm.to(_F32), S)
    y = y + xs.to(_F32) * p["D"][None, :, None]
    y = y.reshape(B_, 1, dn)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps).to(ct)
    out = torch.einsum("ble,ed->bld", y, p["w_out"].to(ct))
    return out, {"conv": new_conv, "ssm": S}
