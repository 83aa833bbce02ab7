"""Model building blocks shared by all 10 architectures (port of
``repro.models.layers``).

Plain-tree parameters (dicts of tensors) + pure apply functions, the JAX
package's layout: parameter tensors keep semantic axes separate (e.g. wq:
(d_model, heads, head_dim)), and the block bodies are ``torch.einsum`` on
the JAX package's subscripts, so a parameter tree crosses between the two
packages with no transpose (``repro_torch.models.convert``).

Numerics: matmuls in cfg.compute_dtype (bf16 on the card), softmax/norm/
router in float32.  Every function is free of in-place writes to its
inputs, ``.item()`` and branches on tensor values, so ``torch.func``
transforms (the Hessian-vector products of ``repro_torch.spectral``) run
through it.

Initializers take an :class:`Init` (a seeded generator on the target
device, or the ``meta`` device for shapes only) and ``lead``, the leading
axes of a stacked layer tree: a block's parameters for L layers are made
at once with ``lead=(L,)``, fan-in read from the per-layer shape, as the
JAX package's vmapped initializers do.  Values are torch's draws, not the
JAX package's: parity tests carry the JAX package's parameters across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}
_F32 = torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"`` ...)."""
    return _DTYPES[name]


def _dt(cfg):
    return torch_dtype(cfg.param_dtype)


def _ct(cfg):
    return torch_dtype(cfg.compute_dtype)


class Init:
    """Parameter factory: float32 normal draws from one generator on
    ``device``, cast to the leaf's dtype; on the ``meta`` device shapes
    and dtypes only, nothing allocated."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, dtype, scale: float):
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, dtype=_F32,
                        device=self.device)
        return (x * scale).to(dtype)

    def full(self, shape, value: float, dtype):
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def tensor(self, values, dtype):
        """A constant tensor (float64 values cast to ``dtype``)."""
        if self.gen is None:
            return torch.empty(tuple(values.shape), dtype=dtype,
                               device=self.device)
        return values.to(device=self.device, dtype=dtype)


def _init(ini: Init, shape, dtype, scale=None, lead=()):
    fan_in = shape[0] if len(shape) >= 1 else 1
    if scale is None:
        scale = fan_in ** -0.5
    return ini.normal(tuple(lead) + tuple(shape), dtype, scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(ini: Init, d: int, dtype, lead=()) -> Params:
    return {"scale": ini.full(tuple(lead) + (d,), 1.0, dtype)}


def rmsnorm(params: Params, x, eps: float):
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(_F32)).to(x.dtype)


def rmsnorm_headwise(scale, x, eps: float):
    """Per-head q/k norm (qwen3): x (..., heads, head_dim)."""
    xf = x.to(_F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(_F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE + none)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=_F32,
                                         device=device) / half))


def _rotate(x, ang):
    """Rotate the two halves of x's last axis by ``ang`` (B, S, half)."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(_F32) * freqs)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE: rotary dims split into (t, h, w) sections, each
    rotated by its own position stream.  positions3: (3, B, S)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = _rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device),
        output_size=half)                                         # (half,)
    pos = positions3[sec_id]                                      # (half,B,S)
    return _rotate(x, torch.movedim(pos, 0, -1).to(_F32) * freqs)


def sinusoidal_positions(seq_len: int, d_model: int, dtype=_F32,
                         device=None):
    """Whisper-style fixed sinusoidal position embedding (S, D), computed
    in float64 and cast (the JAX package's table under x64)."""
    half = d_model // 2
    f64 = dict(dtype=torch.float64, device=device)
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, **f64)
                      / max(half - 1, 1))
    ang = torch.arange(seq_len, **f64)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# GQA attention (with optional qk-norm, qkv bias, rope variants, KV cache)
# ---------------------------------------------------------------------------

def init_attention(ini: Init, cfg, lead=()) -> Params:
    d, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = _dt(cfg)
    p = {
        "wq": _init(ini, (d, H, hd), dt, lead=lead),
        "wk": _init(ini, (d, G, hd), dt, lead=lead),
        "wv": _init(ini, (d, G, hd), dt, lead=lead),
        "wo": _init(ini, (H, hd, d), dt, scale=(H * hd) ** -0.5, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.full(tuple(lead) + (H, hd), 0.0, dt)
        p["bk"] = ini.full(tuple(lead) + (G, hd), 0.0, dt)
        p["bv"] = ini.full(tuple(lead) + (G, hd), 0.0, dt)
    if cfg.qk_norm:
        p["q_norm"] = ini.full(tuple(lead) + (hd,), 1.0, dt)
        p["k_norm"] = ini.full(tuple(lead) + (hd,), 1.0, dt)
    return p


def _project_qkv(p, cfg, x, positions):
    ct = _ct(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(ct))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(ct))
    if cfg.qkv_bias:
        q = q + p["bq"].to(ct)
        k = k + p["bk"].to(ct)
        v = v + p["bv"].to(ct)
    if cfg.qk_norm:
        q = rmsnorm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_headwise(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_style == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_style == "mrope":
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _masked(scores, mask):
    return torch.where(mask, scores, torch.full((), -1e30, dtype=_F32,
                                                device=scores.device))


def _sdpa(q, k, v, mask, cfg):
    """q: (B,S,H,hd); k,v: (B,T,G,hd); grouped heads; f32 softmax."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    qg = q.reshape(B, S, G, rep, hd)
    scale = hd ** -0.5
    scores = torch.einsum("bsgrk,btgk->bgrst", qg, k).to(_F32) * scale
    if mask is not None:
        scores = _masked(scores, mask)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgk->bsgrk", probs, v)
    return out.reshape(B, S, H, hd)


# Sequences at or above this length use the online-softmax KV-block loop
# (never materializes the S x T score matrix -- peak is S x CHUNK).
FLASH_THRESHOLD = 8192
FLASH_KV_CHUNK = 1024


def _sdpa_chunked(q, k, v, cfg, *, causal: bool):
    """Memory-efficient attention: a loop over KV chunks with running
    (max, denominator, accumulator) -- the FlashAttention recurrence in
    plain torch.  Peak score tensor is (B, G, rep, S, CHUNK) instead of
    (..., S, T).  Unlike the JAX package's scan, the chunk bodies are not
    rematerialized: autograd keeps each chunk's probabilities."""
    B, S, H, hd = q.shape
    G = k.shape[2]
    rep = H // G
    Tlen = k.shape[1]
    C = min(FLASH_KV_CHUNK, Tlen)
    assert Tlen % C == 0, (Tlen, C)
    qg = q.reshape(B, S, G, rep, hd)
    scale = hd ** -0.5
    qpos = torch.arange(S, device=q.device)
    acc = torch.zeros((B, S, G, rep, hd), dtype=_F32, device=q.device)
    m = torch.full((B, G, rep, S), -math.inf, dtype=_F32, device=q.device)
    denom = torch.zeros((B, G, rep, S), dtype=_F32, device=q.device)
    for t0 in range(0, Tlen, C):
        kt, vt = k[:, t0:t0 + C], v[:, t0:t0 + C]
        s = torch.einsum("bsgrk,btgk->bgrst", qg, kt).to(_F32) * scale
        if causal:
            kpos = t0 + torch.arange(C, device=q.device)
            s = _masked(s, (qpos[:, None] >= kpos[None, :])[None, None, None])
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        denom = denom * alpha + torch.sum(pr, dim=-1)
        pv = torch.einsum("bgrst,btgk->bsgrk", pr.to(q.dtype), vt)
        acc = acc * torch.movedim(alpha, (1, 2, 3), (2, 3, 1))[..., None] + pv
        m = m_new
    denom = torch.movedim(denom, (1, 2, 3), (2, 3, 1))
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(B, S, H, hd).to(q.dtype)


def _attend(core, q, k, v, *rest):
    """``core(q, k, v, *rest)`` -- an attention core, independent per
    sequence and per head group -- on plain tensors, or on each rank's
    shard of ``DTensor`` q, k, v (batch over the visible data-parallel
    axes, heads over 'model' where both head counts divide its extent)
    under ``local_map``: the core's reshapes merge sharded dims, which
    DTensor's view propagation does not take in every release."""
    from repro_torch.dist.sharding import _is_dtensor
    if not _is_dtensor(q):
        return core(q, k, v, *rest)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import (_extent, _visible_dp_axes,
                                           placements)
    mesh = q.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = _visible_dp_axes(mesh, q.shape[0])
    heads = ("model" if "model" in names
             and q.shape[2] % _extent(mesh, "model") == 0
             and k.shape[2] % _extent(mesh, "model") == 0 else None)
    pl = placements((dp, None, heads, None), mesh)
    ins = (pl, pl, pl) + (None,) * len(rest)
    return local_map(core, out_placements=list(pl), in_placements=ins,
                     in_grad_placements=ins, device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, *rest)


def _causal_mask(S, device):
    it = torch.arange(S, device=device)
    return (it[None, :, None] >= it[None, None, :])[:, None, None, :, :]


def attention_forward(p, cfg, x, positions, *, causal=True,
                      return_cache=False):
    """Full-sequence attention (train / prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if S >= FLASH_THRESHOLD and k.shape[1] % FLASH_KV_CHUNK == 0:
        out = _attend(lambda q_, k_, v_: _sdpa_chunked(q_, k_, v_, cfg,
                                                      causal=causal),
                      q, k, v)
    else:
        mask = _causal_mask(S, x.device) if causal else None
        out = _attend(lambda q_, k_, v_: _sdpa(q_, k_, v_, mask, cfg),
                      q, k, v)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(_ct(cfg)))
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def _write_at(cache, new, pos):
    """``cache`` with ``new`` written at sequence position ``pos`` (axis
    1), out of place (the JAX package's dynamic_update_slice)."""
    index = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    return cache.index_copy(1, index, new.to(cache.dtype))


def attention_decode(p, cfg, x, cache, pos):
    """One-token decode against a pre-allocated KV cache.

    x: (B, 1, D); cache: {"k","v"}: (B, S_max, G, hd); pos: int.
    """
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k = _write_at(cache["k"], k_new, pos)
    v = _write_at(cache["v"], v_new, pos)
    S_max = k.shape[1]
    mask = (torch.arange(S_max, device=x.device)[None, :]
            <= pos)[None, None, None, :, :]
    out = _attend(lambda q_, k_, v_: _sdpa(q_, k_, v_, mask, cfg), q, k, v)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(_ct(cfg)))
    return y, {"k": k, "v": v}


def init_cross_attention(ini: Init, cfg, lead=()) -> Params:
    return init_attention(ini, cfg, lead)


def cross_attention(p, cfg, x, kv_cache):
    """Decoder cross-attention against precomputed encoder K/V."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(_ct(cfg)))
    out = _attend(lambda q_, k_, v_: _sdpa(q_, k_, v_, None, cfg),
                  q, kv_cache["k"], kv_cache["v"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(_ct(cfg)))


def encoder_kv(p, cfg, enc_out):
    k = torch.einsum("bsd,dgk->bsgk", enc_out, p["wk"].to(_ct(cfg)))
    v = torch.einsum("bsd,dgk->bsgk", enc_out, p["wv"].to(_ct(cfg)))
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (minicpm3 / deepseek-v2 style)
# ---------------------------------------------------------------------------

def init_mla(ini: Init, cfg, lead=()) -> Params:
    d, H = cfg.d_model, cfg.num_heads
    rq, rkv = cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank
    dn, dr, dv = cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_head_dim
    dt = _dt(cfg)
    return {
        "wq_a": _init(ini, (d, rq), dt, lead=lead),
        "q_a_norm": ini.full(tuple(lead) + (rq,), 1.0, dt),
        "wq_b": _init(ini, (rq, H, dn + dr), dt, lead=lead),
        "wkv_a": _init(ini, (d, rkv + dr), dt, lead=lead),
        "kv_a_norm": ini.full(tuple(lead) + (rkv,), 1.0, dt),
        "wk_b": _init(ini, (rkv, H, dn), dt, lead=lead),
        "wv_b": _init(ini, (rkv, H, dv), dt, lead=lead),
        "wo": _init(ini, (H, dv, d), dt, scale=(H * dv) ** -0.5, lead=lead),
    }


def _mla_latents(p, cfg, x, positions):
    """Compressed KV latent c (B,S,rkv) + shared rotary key (B,S,1,dr)."""
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(_ct(cfg)))
    r = cfg.mla_kv_lora_rank
    c, k_rope = kv_a[..., :r], kv_a[..., r:]
    c = rmsnorm({"scale": p["kv_a_norm"]}, c, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c, k_rope


def _mla_queries(p, cfg, x, positions):
    dn = cfg.mla_qk_nope_dim
    q_a = torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(_ct(cfg)))
    q_a = rmsnorm({"scale": p["q_a_norm"]}, q_a, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_a, p["wq_b"].to(_ct(cfg)))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_chunked(q_lat, q_rope, c, kr, scale, *, causal: bool):
    """Online-softmax MLA attention over latent chunks (FlashAttention
    recurrence in latent space).  q_lat: (B,S,H,r); q_rope: (B,S,H,dr);
    c: (B,T,r); kr: (B,T,dr).  Returns ctx_lat (B,S,H,r)."""
    B, S, H, r = q_lat.shape
    Tlen = c.shape[1]
    C = min(FLASH_KV_CHUNK, Tlen)
    assert Tlen % C == 0, (Tlen, C)
    dev = q_lat.device
    qpos = torch.arange(S, device=dev)
    acc = torch.zeros((B, S, H, r), dtype=_F32, device=dev)
    m = torch.full((B, H, S), -math.inf, dtype=_F32, device=dev)
    denom = torch.zeros((B, H, S), dtype=_F32, device=dev)
    for t0 in range(0, Tlen, C):
        ct, krt = c[:, t0:t0 + C], kr[:, t0:t0 + C]
        s = (torch.einsum("bshr,btr->bhst", q_lat, ct)
             + torch.einsum("bshk,btk->bhst", q_rope, krt)).to(_F32) * scale
        if causal:
            kpos = t0 + torch.arange(C, device=dev)
            s = _masked(s, (qpos[:, None] >= kpos[None, :])[None, None])
        m_new = torch.maximum(m, torch.amax(s, dim=-1))          # (B,H,S)
        alpha = torch.exp(m - m_new)
        pr = torch.exp(s - m_new[..., None])
        denom = denom * alpha + torch.sum(pr, dim=-1)
        pv = torch.einsum("bhst,btr->bshr", pr.to(q_lat.dtype), ct)
        acc = acc * torch.movedim(alpha, (1, 2), (2, 1))[..., None] + pv
        m = m_new
    denom = torch.movedim(denom, (1, 2), (2, 1))
    return (acc / torch.clamp(denom, min=1e-30)[..., None]).to(q_lat.dtype)


def mla_forward(p, cfg, x, positions, *, causal=True, return_cache=False):
    """Latent-space attention: scores/context computed against the cached
    latent c, with the nope-key projection absorbed into the query (the
    standard MLA decode identity, applied at train time too so the exact
    same einsums are exercised everywhere).  Long sequences use the
    online-softmax chunked path (never materializes the S x T scores)."""
    B, S, _ = x.shape
    ct = _ct(cfg)
    c, k_rope = _mla_latents(p, cfg, x, positions)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    # Absorb W_kb: q~ = W_kb^T q_nope  -> (B,S,H,rkv)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(ct))
    scale = (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim) ** -0.5
    if S >= FLASH_THRESHOLD and S % FLASH_KV_CHUNK == 0:
        ctx_lat = _mla_chunked(q_lat, q_rope, c, k_rope[:, :, 0, :],
                               scale, causal=causal)
    else:
        scores = (torch.einsum("bshr,btr->bhst", q_lat, c)
                  + torch.einsum("bshk,btgk->bhst", q_rope, k_rope)
                  ).to(_F32) * scale
        if causal:
            it = torch.arange(S, device=x.device)
            scores = _masked(scores, it[None, None, :, None]
                             >= it[None, None, None, :])
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, c)
    out = torch.einsum("bshr,rhv->bshv", ctx_lat, p["wv_b"].to(ct))
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(ct))
    if return_cache:
        return y, {"c": c, "k_rope": k_rope[:, :, 0, :]}
    return y


def mla_decode(p, cfg, x, cache, pos):
    """One-token MLA decode: the cache holds only the latent + rotary key --
    this is the memory win MLA exists for (rkv + dr per token, not 2*H*hd)."""
    B = x.shape[0]
    ct = _ct(cfg)
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    c_new, k_rope_new = _mla_latents(p, cfg, x, positions)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    c = _write_at(cache["c"], c_new, pos)
    kr = _write_at(cache["k_rope"], k_rope_new[:, :, 0, :], pos)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(ct))
    scale = (cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c)
              + torch.einsum("bshk,btk->bhst", q_rope, kr)).to(_F32) * scale
    S_max = c.shape[1]
    mask = (torch.arange(S_max, device=x.device) <= pos)[None, None, None, :]
    probs = torch.softmax(_masked(scores, mask), dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c)
    out = torch.einsum("bshr,rhv->bshv", ctx_lat, p["wv_b"].to(ct))
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(ct))
    return y, {"c": c, "k_rope": kr}


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(ini: Init, cfg, d_ff=None, lead=()) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = _dt(cfg)
    return {
        "w_gate": _init(ini, (d, f), dt, lead=lead),
        "w_up": _init(ini, (d, f), dt, lead=lead),
        "w_down": _init(ini, (f, d), dt, scale=f ** -0.5, lead=lead),
    }


def mlp_forward(p, cfg, x):
    ct = _ct(cfg)
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(ct))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(ct))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"].to(ct))


# ---------------------------------------------------------------------------
# MoE with top-k routing, capacity + sort-based dispatch
# ---------------------------------------------------------------------------

def init_moe(ini: Init, cfg, lead=()) -> Params:
    d, E, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    dt = _dt(cfg)
    p = {
        "router": _init(ini, (d, E), _F32, lead=lead),
        "w_gate": _init(ini, (E, d, f), dt, lead=lead),
        "w_up": _init(ini, (E, d, f), dt, lead=lead),
        "w_down": _init(ini, (E, f, d), dt, scale=f ** -0.5, lead=lead),
    }
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(ini, cfg, d_ff=cfg.d_ff, lead=lead)
    return p


def moe_route(p, cfg, x):
    """Top-k routing of x (B, S, D)'s tokens: (probs (T, E), gate values
    (T, k), expert ids (T, k)), float32.

    The top k come from a stable descending sort: among equal
    probabilities the lower expert id comes first, the tie rule of the
    JAX package's ``lax.top_k``."""
    T = x.shape[0] * x.shape[1]
    logits = torch.einsum("td,de->te", x.reshape(T, -1).to(_F32),
                          p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, cfg.moe_top_k)
    return probs, gate_vals, expert_idx


def _top_k(probs, k: int):
    """(gate values normalized over the k, expert ids) of the last axis's
    k largest probabilities, ties to the lower id."""
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, -1,
                                                  keepdim=True), min=1e-9)
    return gate_vals, expert_idx


def moe_capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens of one dispatch
    group (a Python int)."""
    return int(max(1, round(tokens * cfg.moe_top_k / cfg.moe_num_experts
                            * cfg.moe_capacity_factor)))


def moe_dispatch_meta(eid, cap: int):
    """Sort-based capacity assignment of one group's flat (Tg*k,) expert
    ids: (order, eid_s, slot_c, keep).  Entries sorted stably by expert id
    take consecutive slots of their expert; those past ``cap`` are dropped
    (``keep`` False, slot ``cap``)."""
    Tk = eid.shape[0]
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    first = torch.searchsorted(eid_s, eid_s, side="left")
    slot = torch.arange(Tk, device=eid.device) - first
    keep = slot < cap
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap))
    return order, eid_s, slot_c, keep


def moe_group_dispatch(xg, eidg, gvg, cap: int, E: int, k: int):
    """One dispatch group's sort-based dispatch, the JAX package's
    ``_moe_group_dispatch``: xg (Tg, D); eidg, gvg (Tg*k,).  Returns (buf
    (E, cap, D), (eid_s, slot_c, tid_s, gv_s, keep)).  Every index stays
    inside the group."""
    order, eid_s, slot_c, keep = moe_dispatch_meta(eidg, cap)
    gv_s = gvg[order]
    tid_s = order // k
    buf = torch.zeros((E, cap + 1, xg.shape[1]), dtype=xg.dtype,
                      device=xg.device)
    buf = buf.index_put((eid_s, slot_c), xg[tid_s])[:, :cap]
    return buf, (eid_s, slot_c, tid_s, gv_s, keep)


def moe_group_combine(out, meta, Tg: int, dtype):
    """One group's combine, the JAX package's ``_moe_group_combine``: the
    kept slots of ``out`` (E, cap, D), weighted by their gates, added back
    to their tokens' rows of a (Tg, D) output."""
    eid_s, slot_c, tid_s, gv_s, keep = meta
    cap = out.shape[1]
    y_s = torch.where(keep[:, None],
                      out[eid_s, torch.clamp(slot_c, max=cap - 1)],
                      torch.zeros((), dtype=out.dtype, device=out.device))
    y_s = y_s * gv_s[:, None].to(out.dtype)
    y = torch.zeros((Tg, out.shape[2]), dtype=dtype, device=out.device)
    return y.index_add(0, tid_s, y_s.to(dtype))


def _experts(p, cfg, buf, sub):
    """The experts' SwiGLU on dispatched slots (``sub`` "ecd" or "gecd")."""
    ct = _ct(cfg)
    out = sub.replace("d", "f")
    g = torch.einsum(f"{sub},edf->{out}", buf, p["w_gate"].to(ct))
    u = torch.einsum(f"{sub},edf->{out}", buf, p["w_up"].to(ct))
    return torch.einsum(f"{out},efd->{sub}", F.silu(g) * u,
                        p["w_down"].to(ct))


def moe_groups(T: int) -> int:
    """Dispatch groups of T tokens: the data-parallel extent visible here
    (``dist.sharding.dp_axis_extent``), 1 where it does not divide T."""
    from repro_torch.dist.sharding import dp_axis_extent
    G = dp_axis_extent()
    return G if T % G == 0 else 1


def moe_forward(p, cfg, x):
    """Returns (y, aux_loss).  Grouped sort-based capacity dispatch:

      tokens -> top-k experts -> per-DP-group stable sort by expert id ->
      per-expert contiguous slots (capacity C, overflow dropped) ->
      expert matmuls (G, E, C, d) -> combine weighted by router gates.

    The groups axis G is the data-parallel shard count (``moe_groups``, 1
    on a single device), so every dispatch index stays inside a group.
    On plain tensors the groups run one after another, each as the
    one-group form (G = 1 is that form alone).  On ``DTensor``s (the
    multi-rank trainer) the group axis is sharded over the data-parallel
    mesh axes and the index work (sort, ``searchsorted``, scatter, gather)
    runs shard-local under ``local_map`` -- DTensor has no sharding
    strategy for those ops -- while the router and expert matmuls stay
    DTensor ops, their collectives inserted by sharding propagation."""
    from repro_torch.dist.sharding import _is_dtensor
    B, S, D = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    G = moe_groups(T)
    if _is_dtensor(x):
        return _moe_forward_dtensor(p, cfg, x, G if B % G == 0 else 1)
    Tg = T // G
    probs, gate_vals, expert_idx = moe_route(p, cfg, x)

    # Load-balance auxiliary loss (Switch-style).
    me = torch.mean(probs, dim=0)                                   # (E,)
    ce = torch.mean(F.one_hot(expert_idx[:, 0], E).to(_F32), dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    cap = moe_capacity(cfg, Tg)
    eid = expert_idx.reshape(G, Tg * k)
    gv = gate_vals.reshape(G, Tg * k)
    xf = x.reshape(G, Tg, D)
    ys = []
    for g in range(G):
        buf, meta = moe_group_dispatch(xf[g], eid[g], gv[g], cap, E, k)
        out = _experts(p, cfg, buf, "ecd")
        ys.append(moe_group_combine(out, meta, Tg, x.dtype))
    y = ys[0] if G == 1 else torch.cat(ys)

    if cfg.moe_shared_expert:
        y = y + mlp_forward(p["shared"], cfg,
                            x.reshape(1, T, D))[0].to(x.dtype)
    return y.reshape(B, S, D), aux


def _moe_forward_dtensor(p, cfg, x, G: int):
    """:func:`moe_forward` on a ``DTensor`` x, the group axis sharded over
    the visible data-parallel mesh axes of x's mesh.  Group g is batch
    rows [g B/G, (g+1) B/G), so G must divide B (the caller makes G 1
    where it does not, where the JAX package's groups would split a
    sequence); the reshapes between (B, S, D) and (G, Tg, D) run on each
    rank's shard."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import _visible_dp_axes, placements
    B, S, D = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T = B * S
    Tg = T // G
    mesh = x.device_mesh
    grp = placements((_visible_dp_axes(mesh, G),), mesh)

    def lmap(fn, n_out, n_in):
        return local_map(fn, out_placements=list(grp) if n_out == 1
                         else (grp,) * n_out,
                         in_placements=(grp,) * n_in,
                         in_grad_placements=(grp,) * n_in,
                         device_mesh=mesh, redistribute_inputs=True)

    xf = lmap(lambda xl: xl.reshape(-1, Tg, D), 1, 1)(x)
    logits = torch.einsum("gtd,de->gte", xf.to(_F32), p["router"])
    probs = torch.softmax(logits, dim=-1)

    def route(pr):
        gate_vals, expert_idx = _top_k(pr, k)
        top1 = F.one_hot(expert_idx[..., 0], E).to(_F32)
        return (gate_vals.reshape(pr.shape[0], -1),
                expert_idx.reshape(pr.shape[0], -1), top1)

    gv, eid, top1 = lmap(route, 3, 1)(probs)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(top1, dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    cap = moe_capacity(cfg, Tg)

    def dispatch(xl, el, gl):
        parts = [moe_group_dispatch(xl[g], el[g], gl[g], cap, E, k)
                 for g in range(xl.shape[0])]
        stack = [torch.stack([pt[0] for pt in parts])]
        for i in range(5):
            stack.append(torch.stack([pt[1][i] for pt in parts]))
        return tuple(stack)

    buf, *meta = lmap(dispatch, 6, 3)(xf, eid, gv)
    out = _experts(p, cfg, buf, "gecd")

    def combine(ol, *ml):
        y = torch.stack([moe_group_combine(ol[g], [m[g] for m in ml],
                                           Tg, x.dtype)
                         for g in range(ol.shape[0])])
        return y.reshape(-1, S, D)

    y = lmap(combine, 1, 6)(out, *meta)
    if cfg.moe_shared_expert:
        y = y + mlp_forward(p["shared"], cfg, x).to(x.dtype)
    return y, aux
