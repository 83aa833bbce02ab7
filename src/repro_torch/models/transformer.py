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
reentrant), the JAX package's ``jax.checkpoint``.  The activation
constraints sit where the JAX package's do (``dist.sharding``): they
return a plain tensor untouched, and on the multi-rank trainer's
``DTensor``s pin the batch (or sequence) layout between blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tune import resolve_device
from repro_torch.dist.sharding import (_is_dtensor, constrain_batch_acts,
                                       constrain_gathered_acts,
                                       constrain_seq_model_acts,
                                       gather_params, model_axis_extent)
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

def _pin_block_input(cfg, x):
    """Heads that don't divide the TP extent would replicate the score
    tensor across 'model'; fall back to sequence parallelism instead."""
    if cfg.num_heads % max(model_axis_extent(), 1) != 0:
        return constrain_seq_model_acts(x)
    return constrain_batch_acts(x)


def _attn_block(p, cfg, x, positions, enc_kv=None, causal=True):
    p = gather_params(p)
    x = _pin_block_input(cfg, x)
    h = constrain_gathered_acts(nn.rmsnorm(p["ln1"], x, cfg.norm_eps))
    if cfg.attention == "mla":
        h = nn.mla_forward(p["attn"], cfg, h, positions, causal=causal)
    else:
        h = nn.attention_forward(p["attn"], cfg, h, positions, causal=causal)
    x = x + h
    if enc_kv is not None:
        h = constrain_gathered_acts(nn.rmsnorm(p["ln_x"], x, cfg.norm_eps))
        x = x + nn.cross_attention(p["xattn"], cfg, h, enc_kv)
    h = constrain_gathered_acts(nn.rmsnorm(p["ln2"], x, cfg.norm_eps))
    aux = _zero(x.device)
    if "moe" in p:
        h, aux = nn.moe_forward(p["moe"], cfg, h)
    else:
        h = nn.mlp_forward(p["mlp"], cfg, h)
    return x + h, aux


def _ssm_block(p, cfg, x):
    p = gather_params(p)
    x = constrain_batch_acts(x)
    h = constrain_gathered_acts(nn.rmsnorm(p["ln1"], x, cfg.norm_eps))
    return x + _batch_local(
        lambda mp, hh: ssm_mod.mamba2_forward(mp, cfg, hh), p["mixer"], h)


# ---------------------------------------------------------------------------
# Training / full-sequence forward
# ---------------------------------------------------------------------------

def _batch_local(fn, params, *acts):
    """``fn(params, *acts)`` -- the Mamba2 mixer, whose chunk scan's
    reshapes, cumulative sums and segment sums have no DTensor sharding
    strategy -- on plain tensors, or on each rank's batch shard of
    ``DTensor`` activations under ``local_map``: the parameters gathered
    whole on every rank (no tensor parallelism inside the mixer), their
    gradients summed over the data-parallel ranks; every activation,
    state and cache leaf batch-first and sharded over the visible
    data-parallel axes."""
    from repro_torch.dist.sharding import _visible_dp_axes, placements
    first = acts[0]
    if not _is_dtensor(first):
        return fn(params, *acts)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_map as pt_map

    mesh = first.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = _visible_dp_axes(mesh, first.shape[0])
    dp_names = dp if isinstance(dp, tuple) else ((dp,) if dp else ())
    rep = tuple(Replicate() for _ in names)
    grad = tuple(Partial() if n in dp_names else Replicate() for n in names)

    def batch(x):
        return placements((dp,) + (None,) * (x.ndim - 1), mesh)

    # The output structure, from a run on meta tensors of local shapes.
    ext = 1
    for name in dp_names:
        ext *= mesh.size(names.index(name))

    def meta(x, batch_first=False):
        shape = list(x.shape)
        if batch_first:
            shape[0] //= ext
        return torch.empty(shape, dtype=x.dtype, device="meta")
    probe = fn(pt_map(meta, params),
               *pt_map(lambda x: meta(x, True), acts))
    flat_out, _ = tree_flatten(probe)

    flat_p, _ = tree_flatten(params)
    flat_a, _ = tree_flatten(acts)
    ins = [rep] * len(flat_p) + [batch(a) for a in flat_a]
    grads = [grad] * len(flat_p) + [batch(a) for a in flat_a]
    outs = [batch(o) for o in flat_out]
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1
                     else list(outs[0]), in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(params, *acts)


def _embed(params, cfg, tokens):
    table = params["embed"].to(_ct(cfg))
    if _is_dtensor(table):
        return constrain_batch_acts(_lookup_sharded(table, tokens))
    return constrain_batch_acts(table[tokens])


def _lookup_sharded(table, tokens):
    """``table[tokens]`` for a ``DTensor`` table (V, D), each rank looking
    up its own vocabulary slice (over 'model' where it divides; the table
    gathered over the other axes): a rank whose slice lacks a token adds
    0, so the rows are a partial sum over 'model'.  The table's gradient
    comes back summed over the data-parallel ranks.  (DTensor's
    strategies for indexing's backward and for embedding's masked partial
    sum do not hold in every release.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import (_extent, _visible_dp_axes,
                                           placements)
    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = _visible_dp_axes(mesh, tokens.shape[0])
    dp_names = dp if isinstance(dp, tuple) else ((dp,) if dp else ())
    vocab = ("model" if "model" in names
             and table.shape[0] % _extent(mesh, "model") == 0 else None)
    tp = placements((vocab, None), mesh)
    bp = placements((dp, None), mesh)
    grad, out = [], []
    for name in names:
        if name == vocab:
            grad.append(Shard(0))
            out.append(Partial())
        elif name in dp_names:
            grad.append(Partial())
            out.append(Shard(0))
        else:
            grad.append(Replicate())
            out.append(Replicate())

    def lookup(tl, tok):
        rows = tl.shape[0]
        v0 = mesh.get_local_rank("model") * rows if vocab else 0
        idx = tok.long() - v0
        ok = (idx >= 0) & (idx < rows)
        got = tl[idx.clamp(0, rows - 1)]
        return torch.where(ok[..., None], got,
                           torch.zeros((), dtype=got.dtype, device=got.device))

    return local_map(lookup, out_placements=out, in_placements=(tp, bp),
                     in_grad_placements=(tuple(grad), bp), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _unembed(params, cfg, x):
    params = {k: gather_params(params[k]) for k in
              ("final_norm", "head", "embed") if k in params}
    x = constrain_batch_acts(x)
    x = constrain_gathered_acts(
        nn.rmsnorm(params["final_norm"], x, cfg.norm_eps))
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
        lp = gather_params(lp)
        x = _pin_block_input(cfg, x)
        h = constrain_gathered_acts(nn.rmsnorm(lp["ln1"], x, cfg.norm_eps))
        x = x + nn.attention_forward(lp["attn"], cfg, h, zeros, causal=False)
        h = constrain_gathered_acts(nn.rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = x + nn.mlp_forward(lp["mlp"], cfg, h)
    return constrain_gathered_acts(
        nn.rmsnorm(params["enc_norm"], x, cfg.norm_eps))


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
        lp = gather_params(lp)
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
    accumulating ``index_put``, which has a deterministic CUDA kernel.
    On ``DTensor`` logits the pick runs on each rank's shard
    (``_gold_sharded``)."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          encoder_input=batch.get("frames"), remat=remat)
    labels = batch["labels"]
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        gold = _gold_sharded(logits, labels)
    else:
        flat = logits.reshape(-1, logits.shape[-1])
        rows = torch.arange(flat.shape[0], device=flat.device)
        gold = flat[rows, labels.reshape(-1).long()].reshape(labels.shape)
    ce = torch.mean(lse - gold)
    return ce + aux, {"ce": ce, "aux": aux}


def _gold_sharded(logits, labels):
    """The gold logits of ``DTensor`` logits (B, S, V), each rank picking
    from its own shard: batch over the visible data-parallel axes, the
    vocabulary over 'model' where it divides.  A rank whose vocabulary
    slice lacks a label contributes 0, so the result is a partial sum over
    'model'.  (Indexing the whole DTensor would replicate the logits of
    the global batch on every rank: DTensor has no sharding strategy for
    that gather.)"""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.sharding import (_extent, _visible_dp_axes,
                                           placements)
    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = _visible_dp_axes(mesh, logits.shape[0])
    vocab = ("model" if "model" in names
             and logits.shape[-1] % _extent(mesh, "model") == 0 else None)
    lp = placements((dp, None, vocab), mesh)
    bp = placements((dp, None), mesh)
    out = list(bp)
    if vocab is not None:
        out[names.index("model")] = Partial()

    def pick(lg, lb):
        width = lg.shape[-1]
        v0 = mesh.get_local_rank("model") * width if vocab else 0
        idx = lb.long() - v0
        ok = (idx >= 0) & (idx < width)
        g = torch.gather(lg, -1, idx.clamp(0, width - 1)[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))

    return local_map(pick, out_placements=out, in_placements=(lp, bp),
                     in_grad_placements=(lp, bp), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


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
    lp = gather_params(lp)
    x = constrain_batch_acts(x)
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
    lp = gather_params(lp)
    h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    h, cache = _batch_local(
        lambda mp, hh, cc: ssm_mod.mamba2_decode(mp, cfg, hh, cc),
        lp["mixer"], h, cache)
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
        if _is_dtensor(v):    # out of place: a DTensor takes no slice write
            pad = torch.zeros((B, max_seq - v.shape[1]) + tuple(v.shape[2:]),
                              dtype=v.dtype, device=v.device)
            out[key] = torch.cat([v, pad], dim=1)
            continue
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
        lp = gather_params(lp)
        h = nn.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        h, c = _batch_local(
            lambda mp, hh: ssm_mod.mamba2_forward(mp, cfg, hh,
                                                  return_state=True),
            lp["mixer"], h)
        return x + h, c

    if cfg.family == "ssm":
        new = []
        for lp in _unstack(params["layers"], cfg.num_layers):
            x, c = mamba(lp, x)
            new.append(c)
        return _unembed(params, cfg, x), tree_stack(new)

    if cfg.family == "hybrid":
        groups, per_group, tail = _hybrid_counts(cfg)
        shared = gather_params(params["shared_attn"])
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
        lp = gather_params(lp)
        x = _pin_block_input(cfg, x)
        h = constrain_gathered_acts(nn.rmsnorm(lp["ln1"], x, cfg.norm_eps))
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
        h = constrain_gathered_acts(nn.rmsnorm(lp["ln2"], x, cfg.norm_eps))
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
