"""Model assembly: decoder-only / encoder-decoder / SSM / hybrid stacks
(port of ``repro.models.transformer``).

All architectures share the JAX package's parameter layout:

    params = {
      "embed":   (V, D)
      "head":    (D, V)            -- absent when tie_embeddings
      "final_norm": {...}
      "layers":  tree with leading layer axis (stacked)
      "enc_*":   encoder stack (whisper)
      "shared_attn": single shared block (zamba2)
    }

Where the JAX package runs ``lax.scan`` over a stacked layer tree, the
port unbinds the stack once (one ``unbind`` per leaf, so the backward
pass stacks the layers' gradients in one op) and loops in Python;
``remat`` wraps each loop body in ``torch.utils.checkpoint`` (non-
reentrant), the JAX package's ``jax.checkpoint``.  Its sharding
constraints do nothing on one device and are left out.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tune import resolve_device
from repro_torch.models import layers as nn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map, tree_stack

Params = Dict[str, Any]
_F32 = torch.float32


def _ct(cfg):
    return nn.torch_dtype(cfg.compute_dtype)


def _dt(cfg):
    return nn.torch_dtype(cfg.param_dtype)


def _unstack(tree, n: int) -> list:
    """The n per-layer trees of a stacked tree (one ``unbind`` a leaf)."""
    cols = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda _, c: c[i], tree, cols) for i in range(n)]


def _layer_count(tree) -> int:
    return tree_leaves(tree)[0].shape[0]


def _maybe_remat(fn, remat: bool):
    """``fn`` itself, or ``fn`` under non-reentrant activation
    checkpointing (its activations recomputed in the backward pass)."""
    if not remat:
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def _zero(device):
    return torch.zeros((), dtype=_F32, device=device)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init_block(ini, cfg: ModelConfig, kind: str, lead=()) -> Params:
    """One transformer block's parameters.  kind: attn|moe|ssm|encdec."""
    p: Params = {"ln1": nn.init_rmsnorm(ini, cfg.d_model, _dt(cfg), lead)}
    if kind == "ssm":
        p["mixer"] = ssm_mod.init_mamba2(ini, cfg, lead)
        return p
    if cfg.attention == "mla":
        p["attn"] = nn.init_mla(ini, cfg, lead)
    else:
        p["attn"] = nn.init_attention(ini, cfg, lead)
    p["ln2"] = nn.init_rmsnorm(ini, cfg.d_model, _dt(cfg), lead)
    if kind == "moe":
        p["moe"] = nn.init_moe(ini, cfg, lead)
    else:
        p["mlp"] = nn.init_mlp(ini, cfg, lead=lead)
    if kind == "encdec":
        p["ln_x"] = nn.init_rmsnorm(ini, cfg.d_model, _dt(cfg), lead)
        p["xattn"] = nn.init_cross_attention(ini, cfg, lead)
    return p


def _block_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.moe_num_experts:
        return "moe"
    if cfg.is_encdec:
        return "encdec"
    return "attn"


def _hybrid_counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(num_groups, mamba_per_group, tail_mamba) for the zamba2 layout:
    within each group of `every` blocks the last is the shared attn block."""
    every = cfg.hybrid_attn_every
    groups = cfg.num_layers // every
    tail = cfg.num_layers - groups * every
    return groups, every - 1, tail


def _init_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init_model(rng: int, cfg: ModelConfig, *, device=None) -> Params:
    """Fresh parameters of ``cfg`` from the integer seed ``rng``, on
    ``device`` (None: the card; ``"meta"``: shapes and dtypes only)."""
    ini = nn.Init(rng, _init_device(device))
    V, D = cfg.vocab_size, cfg.d_model
    params: Params = {
        "embed": ini.normal((V, D), _dt(cfg), D ** -0.5),
        "final_norm": nn.init_rmsnorm(ini, D, _dt(cfg)),
    }
    if not cfg.tie_embeddings:
        params["head"] = ini.normal((D, V), _dt(cfg), D ** -0.5)

    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        params["layers"] = _init_block(ini, cfg, "ssm",
                                       lead=(groups * per_group,))
        if tail:
            params["tail_layers"] = _init_block(ini, cfg, "ssm",
                                                lead=(tail,))
        params["shared_attn"] = _init_block(ini, cfg, "attn")
        return params

    params["layers"] = _init_block(ini, cfg, _block_kind(cfg),
                                   lead=(cfg.num_layers,))
    if cfg.is_encdec:
        lead = (cfg.encoder_layers,)
        params["enc_layers"] = {
            "ln1": nn.init_rmsnorm(ini, D, _dt(cfg), lead),
            "attn": nn.init_attention(ini, cfg, lead),
            "ln2": nn.init_rmsnorm(ini, D, _dt(cfg), lead),
            "mlp": nn.init_mlp(ini, cfg, lead=lead)}
        params["enc_norm"] = nn.init_rmsnorm(ini, D, _dt(cfg))
    return params


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------

def _attn_block(p, cfg, x, positions, enc_kv=None, causal=True):
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        h = nn.mla_forward(p["attn"], cfg, h, positions, causal=causal)
    else:
        h = nn.attention_forward(p["attn"], cfg, h, positions, causal=causal)
    x = x + h
    if enc_kv is not None:
        h = nn.rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + nn.cross_attention(p["xattn"], cfg, h, enc_kv)
    h = nn.rmsnorm(p["ln2"], x, cfg.norm_eps)
    aux = _zero(x.device)
    if "moe" in p:
        h, aux = nn.moe_forward(p["moe"], cfg, h)
    else:
        h = nn.mlp_forward(p["mlp"], cfg, h)
    return x + h, aux


def _ssm_block(p, cfg, x):
    h = nn.rmsnorm(p["ln1"], x, cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(p["mixer"], cfg, h)


# ---------------------------------------------------------------------------
# Training / full-sequence forward
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    return params["embed"].to(_ct(cfg))[tokens]


def _unembed(params, cfg, x):
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = params.get("head", None)
    if w is None:
        w = params["embed"].to(_ct(cfg)).T
    else:
        w = w.to(_ct(cfg))
    return torch.einsum("bsd,dv->bsv", x, w)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _encode(params, cfg, frames):
    """Whisper encoder over precomputed frame embeddings (conv stub)."""
    ct = _ct(cfg)
    pos = nn.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                  device=frames.device)
    x = frames.to(ct) + pos[None].to(ct)
    zeros = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    enc = params["enc_layers"]
    for lp in _unstack(enc, _layer_count(enc)):
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + nn.attention_forward(lp["attn"], cfg, h, zeros, causal=False)
        h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + nn.mlp_forward(lp["mlp"], cfg, h)
    return nn.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, encoder_input=None,
            pixel_embeds=None, remat: bool = False):
    """Full-sequence forward.  Returns (logits, aux_loss)."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    if pixel_embeds is not None:
        x = torch.cat([pixel_embeds.to(x.dtype), x], dim=1)
        S = x.shape[1]
    positions = _positions(B, S, x.device)
    aux = _zero(x.device)

    if cfg.family == "ssm":
        body = _maybe_remat(lambda x, lp: _ssm_block(lp, cfg, x), remat)
        for lp in _unstack(params["layers"], cfg.num_layers):
            x = body(x, lp)
        return _unembed(params, cfg, x), aux

    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        shared = params["shared_attn"]
        layers = _unstack(params["layers"], groups * per_group)

        def group_body(x, *gp):
            for lp in gp:
                x = _ssm_block(lp, cfg, x)
            return _attn_block(shared, cfg, x, positions)[0]
        group_body = _maybe_remat(group_body, remat)
        for g in range(groups):
            x = group_body(x, *layers[g * per_group:(g + 1) * per_group])
        if tail:
            for lp in _unstack(params["tail_layers"], tail):
                x = _ssm_block(lp, cfg, x)
        return _unembed(params, cfg, x), aux

    enc_out = None
    if cfg.is_encdec:
        assert encoder_input is not None, "whisper needs encoder frames"
        enc_out = _encode(params, cfg, encoder_input)
        pos_dec = nn.sinusoidal_positions(S, cfg.d_model, device=x.device)
        x = x + pos_dec[None].to(x.dtype)

    def body(x, lp):
        kv = (nn.encoder_kv(lp["xattn"], cfg, enc_out)
              if enc_out is not None else None)
        return _attn_block(lp, cfg, x, positions, enc_kv=kv)
    body = _maybe_remat(body, remat)
    for lp in _unstack(params["layers"], cfg.num_layers):
        x, a = body(x, lp)
        aux = aux + a
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """Next-token cross entropy (f32 logsumexp) + router aux loss.

    The gold logit is picked by indexing, not by the JAX package's one-hot
    contraction (the same value for finite logits): at full width a
    one-hot would be another B x S x V tensor.  Indexing's backward is an
    accumulating ``index_put``, which has a deterministic CUDA kernel."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          encoder_input=batch.get("frames"), remat=remat)
    labels = batch["labels"]
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    gold = flat[rows, labels.reshape(-1).long()].reshape(labels.shape)
    ce = torch.mean(lse - gold)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with per-layer caches
# ---------------------------------------------------------------------------

def init_cache(params, cfg: ModelConfig, batch: int, max_seq: int):
    """Pre-allocated decode caches, stacked over layers, on the
    parameters' device."""
    G, hd = cfg.num_kv_heads, cfg.head_dim
    ct = _ct(cfg)
    dev = params["embed"].device

    def zeros(*shape, dtype=ct):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache(L):
        return {"k": zeros(L, batch, max_seq, G, hd),
                "v": zeros(L, batch, max_seq, G, hd)}

    def mamba_cache(L):
        one = ssm_mod.mamba2_init_cache(cfg, batch, device=dev)
        return tree_map(lambda a: a[None].repeat((L,) + (1,) * a.ndim), one)

    if cfg.family == "ssm":
        return mamba_cache(cfg.num_layers)
    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        caches = {"mamba": mamba_cache(groups * per_group),
                  "shared": attn_cache(groups)}
        if tail:
            caches["tail"] = mamba_cache(tail)
        return caches
    if cfg.attention == "mla":
        L = cfg.num_layers
        return {"c": zeros(L, batch, max_seq, cfg.mla_kv_lora_rank),
                "k_rope": zeros(L, batch, max_seq, cfg.mla_qk_rope_dim)}
    caches = attn_cache(cfg.num_layers)
    if cfg.is_encdec:
        return {"self": caches, "cross": None}   # cross filled at prefill
    return caches


def _decode_attn_block(lp, cfg, x, cache, pos, enc_kv=None):
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attention == "mla":
        h, cache = nn.mla_decode(lp["attn"], cfg, h, cache, pos)
    else:
        h, cache = nn.attention_decode(lp["attn"], cfg, h, cache, pos)
    x = x + h
    if enc_kv is not None:
        h = nn.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
        x = x + nn.cross_attention(lp["xattn"], cfg, h, enc_kv)
    h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        h, _ = nn.moe_forward(lp["moe"], cfg, h)
    else:
        h = nn.mlp_forward(lp["mlp"], cfg, h)
    return x + h, cache


def _mamba_decode_block(lp, cfg, x, cache):
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h, cache = ssm_mod.mamba2_decode(lp["mixer"], cfg, h, cache)
    return x + h, cache


def decode_step(params, cfg: ModelConfig, tokens, caches, pos, *,
                encoder_out=None):
    """One new token for every sequence in the batch.

    tokens: (B, 1) integer; pos: int (or 0-d integer tensor) -- current
    write position (cache holds `pos` valid entries).  Returns (logits
    (B, 1, V), caches).
    """
    x = _embed(params, cfg, tokens)

    if cfg.family == "ssm":
        L = cfg.num_layers
        new = []
        for lp, c in zip(_unstack(params["layers"], L), _unstack(caches, L)):
            x, c = _mamba_decode_block(lp, cfg, x, c)
            new.append(c)
        return _unembed(params, cfg, x), tree_stack(new)

    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        shared = params["shared_attn"]
        layers = _unstack(params["layers"], groups * per_group)
        mcaches = _unstack(caches["mamba"], groups * per_group)
        scaches = _unstack(caches["shared"], groups)
        new_m, new_s = [], []
        for g in range(groups):
            for i in range(g * per_group, (g + 1) * per_group):
                x, c = _mamba_decode_block(layers[i], cfg, x, mcaches[i])
                new_m.append(c)
            x, c = _decode_attn_block(shared, cfg, x, scaches[g], pos)
            new_s.append(c)
        new = {"mamba": tree_stack(new_m), "shared": tree_stack(new_s)}
        if tail:
            new_t = []
            for lp, c in zip(_unstack(params["tail_layers"], tail),
                             _unstack(caches["tail"], tail)):
                x, c = _mamba_decode_block(lp, cfg, x, c)
                new_t.append(c)
            new["tail"] = tree_stack(new_t)
        return _unembed(params, cfg, x), new

    L = cfg.num_layers
    if cfg.is_encdec:
        # position embedding for the *current* decode position
        S_max = caches["self"]["k"].shape[2]
        pos_table = nn.sinusoidal_positions(S_max, cfg.d_model,
                                            device=x.device)
        index = torch.as_tensor(pos, device=x.device).reshape(1).long()
        x = x + pos_table.index_select(0, index)[None].to(x.dtype)
        new = []
        for lp, c, xkv in zip(_unstack(params["layers"], L),
                              _unstack(caches["self"], L),
                              _unstack(caches["cross"], L)):
            x, c = _decode_attn_block(lp, cfg, x, c, pos, enc_kv=xkv)
            new.append(c)
        return _unembed(params, cfg, x), {"self": tree_stack(new),
                                          "cross": caches["cross"]}

    new = []
    for lp, c in zip(_unstack(params["layers"], L), _unstack(caches, L)):
        x, c = _decode_attn_block(lp, cfg, x, c, pos)
        new.append(c)
    return _unembed(params, cfg, x), tree_stack(new)


def _pad_cache(c, B, max_seq):
    """Each (B, S, ...) entry of ``c`` at the front of a zero (B, max_seq,
    ...) buffer."""
    out = {}
    for key, v in c.items():
        buf = torch.zeros((B, max_seq) + tuple(v.shape[2:]), dtype=v.dtype,
                          device=v.device)
        buf[:, :v.shape[1]] = v
        out[key] = buf
    return out


def prefill(params, cfg: ModelConfig, tokens, max_seq: int, *,
            encoder_input=None):
    """Process the prompt, build decode caches.  Returns (logits, caches)."""
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = _positions(B, S, x.device)

    def mamba(lp, x):
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h, c = ssm_mod.mamba2_forward(lp["mixer"], cfg, h, return_state=True)
        return x + h, c

    if cfg.family == "ssm":
        new = []
        for lp in _unstack(params["layers"], cfg.num_layers):
            x, c = mamba(lp, x)
            new.append(c)
        return _unembed(params, cfg, x), tree_stack(new)

    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        shared = params["shared_attn"]
        layers = _unstack(params["layers"], groups * per_group)
        new_m, new_s = [], []
        for g in range(groups):
            for lp in layers[g * per_group:(g + 1) * per_group]:
                x, c = mamba(lp, x)
                new_m.append(c)
            h = nn.rmsnorm(shared["ln1"], x, cfg.norm_eps)
            h, kv = nn.attention_forward(shared["attn"], cfg, h, positions,
                                         causal=True, return_cache=True)
            x = x + h
            h = nn.rmsnorm(shared["ln2"], x, cfg.norm_eps)
            x = x + nn.mlp_forward(shared["mlp"], cfg, h)
            new_s.append(_pad_cache(kv, B, max_seq))
        caches = {"mamba": tree_stack(new_m), "shared": tree_stack(new_s)}
        if tail:
            new_t = []
            for lp in _unstack(params["tail_layers"], tail):
                x, c = mamba(lp, x)
                new_t.append(c)
            caches["tail"] = tree_stack(new_t)
        return _unembed(params, cfg, x), caches

    enc_out = None
    if cfg.is_encdec:
        assert encoder_input is not None
        enc_out = _encode(params, cfg, encoder_input)
        pos_dec = nn.sinusoidal_positions(S, cfg.d_model, device=x.device)
        x = x + pos_dec[None].to(x.dtype)

    self_c, cross_c = [], []
    for lp in _unstack(params["layers"], cfg.num_layers):
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.attention == "mla":
            h, c = nn.mla_forward(lp["attn"], cfg, h, positions,
                                  return_cache=True)
        else:
            h, c = nn.attention_forward(lp["attn"], cfg, h, positions,
                                        return_cache=True)
        x = x + h
        if cfg.is_encdec:
            hh = nn.rmsnorm(lp["ln_x"], x, cfg.norm_eps)
            xkv = nn.encoder_kv(lp["xattn"], cfg, enc_out)
            x = x + nn.cross_attention(lp["xattn"], cfg, hh, xkv)
            cross_c.append(xkv)
        h = nn.rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if "moe" in lp:
            h, _ = nn.moe_forward(lp["moe"], cfg, h)
        else:
            h = nn.mlp_forward(lp["mlp"], cfg, h)
        x = x + h
        self_c.append(_pad_cache(c, B, max_seq))
    logits = _unembed(params, cfg, x)
    if cfg.is_encdec:
        return logits, {"self": tree_stack(self_c),
                        "cross": tree_stack(cross_c)}
    return logits, tree_stack(self_c)
