"""Pipeline parallelism over the 'pod' mesh axis, GPipe schedule (port of
``repro.launch.pipeline``).

On the (pod, data, model) meshes, tensor collectives and gradient
reductions that cross the pod boundary ride the slow links between pods.
Pipelining the *layer* dimension across pods replaces all cross-pod
tensor traffic with one boundary-activation transfer per tick.

GPipe schedule: T = n_micro + n_stages - 1 ticks; stage 0 injects
microbatch t while the last stage retires microbatch t-(n_stages-1).
Bubble fraction = (n_stages-1)/T.  Every stage computes at every tick (on
zeros in the bubbles) and bubble outputs are never collected.

Two forms, one schedule:

  * one process (plain tensors, or no 'pod' axis): the stages run
    stacked on one device, one after another within a tick -- the form
    the JAX package's ``vmap`` over stages computes, and the one
    ``pipeline_forward`` returns;
  * one process per rank (``DTensor`` parameters on a mesh whose 'pod'
    axis has extent n_stages, the layer stack ``Shard(0)`` over 'pod'):
    pod rank s owns stage s's layers.  Its stage computes on local
    tensors (``_local``: the parameters gathered over 'data' and
    'model', their gradients handed back summed over the pods that used
    them and averaged over the data ranks), and the shift is one
    transfer of the boundary activation a tick (``_shift``: an
    all-gather over the pod group, whose backward sends each gradient
    back to its stage).  Every rank builds the same autograd graph, so
    the backward's collectives line up: stage 0's injection and the last
    stage's loss enter as ``flag * value`` on every rank.

Known simplification (as in the JAX package): MoE router aux-loss
contributions from bubble ticks (zero activations) are included in aux.
In the per-rank form each data rank's microbatches are its own rows
(for a dense model the same result as the JAX package's global
microbatches), and the aux loss is averaged over the data ranks.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import _is_dtensor, set_manual_axes
from repro_torch.launch.steps import (_F32, _mesh_context, clip_and_apply,
                                      loss_and_grads)
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _stage_fn(cfg, positions, remat):
    """Apply one stage's layers (a list of per-layer trees) to a
    microbatch: (x, aux summed over the layers)."""
    def layer(x, lp):
        return tf._attn_block(lp, cfg, x, positions)
    layer = tf._maybe_remat(layer, remat)

    def stage(layers, x):
        aux = tf._zero(x.device)
        for lp in layers:
            x, a = layer(x, lp)
            aux = aux + a
        return x, aux
    return stage


def _check(cfg, B, n_stages, n_micro):
    assert cfg.num_layers % n_stages == 0, (cfg.num_layers, n_stages)
    assert B % n_micro == 0, (B, n_micro)


def pipeline_forward(params, cfg: ModelConfig, tokens, *, n_stages: int,
                     n_micro: int, remat: bool = True):
    """Decoder-only forward with the layer stack pipelined over stages, on
    one process.  Returns (logits, aux).  Requires num_layers % n_stages
    == 0 and batch % n_micro == 0.  Exactly equivalent to tf.forward
    (bubbles compute on zeros but their outputs are never collected)."""
    B, S = tokens.shape
    _check(cfg, B, n_stages, n_micro)
    per_stage = cfg.num_layers // n_stages
    mb = B // n_micro

    # 'pod' is the stage axis here, not a data-parallel axis.
    set_manual_axes({"pod"})
    try:
        x = tf._embed(params, cfg, tokens)                  # (B, S, D)
        D = x.shape[-1]
        xs = x.reshape(n_micro, mb, S, D)
        positions = tf._positions(mb, S, x.device)
        layers = tf._unstack(params["layers"], cfg.num_layers)
        stages = [layers[s * per_stage:(s + 1) * per_stage]
                  for s in range(n_stages)]
        stage_fn = _stage_fn(cfg, positions, remat)

        zero_mb = torch.zeros((mb, S, D), dtype=x.dtype, device=x.device)
        state = [zero_mb] * n_stages
        outputs = [None] * n_micro
        aux = tf._zero(x.device)
        for t in range(n_micro + n_stages - 1):
            inject = xs[t] if t < n_micro else zero_mb
            shifted = [inject] + state[:-1]
            ran = [stage_fn(stages[s], shifted[s]) for s in range(n_stages)]
            state = [r[0] for r in ran]
            aux = aux + sum(r[1] for r in ran)
            if t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = state[-1]
        x_out = torch.stack(outputs).reshape(B, S, D)
        logits = tf._unembed(params, cfg, x_out)
    finally:
        set_manual_axes(set())
    return logits, aux


def _ce(logits, labels):
    """Next-token cross entropy in float32 (the gold logit by indexing)."""
    logits = logits.to(_F32)
    lse = torch.logsumexp(logits, dim=-1)
    flat = logits.reshape(-1, logits.shape[-1])
    rows = torch.arange(flat.shape[0], device=flat.device)
    gold = flat[rows, labels.reshape(-1).long()].reshape(labels.shape)
    return torch.mean(lse - gold)


def pipeline_loss_fn(params, cfg: ModelConfig, batch, *, n_stages: int,
                     n_micro: int, remat: bool = True):
    logits, aux = pipeline_forward(params, cfg, batch["tokens"],
                                   n_stages=n_stages, n_micro=n_micro,
                                   remat=remat)
    ce = _ce(logits, batch["labels"])
    return ce + aux, {"ce": ce}


# ---------------------------------------------------------------------------
# One process per rank: stage s on pod rank s
# ---------------------------------------------------------------------------

def _all_gather(x, group):
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


class _Shift(torch.autograd.Function):
    """Rank r of the pod group receives rank ``src[r]``'s tensor (one
    all-gather); the backward sends each rank's gradient back to the rank
    it came from, summed where several took it."""

    @staticmethod
    def forward(ctx, x, group, src):
        import torch.distributed as dist
        ctx.group, ctx.src = group, src
        ctx.rank = dist.get_rank(group)
        return _all_gather(x, group)[src[ctx.rank]].clone()

    @staticmethod
    def backward(ctx, g):
        gathered = _all_gather(g, ctx.group)
        mine = [j for j, s in enumerate(ctx.src) if s == ctx.rank]
        grad = torch.zeros_like(g)
        for j in mine:
            grad = grad + gathered[j]
        return grad, None, None


def _shift(x, group, stages):
    """Stage s receives stage s-1's boundary activation (stage 0 gets the
    last stage's, which its injection flag zeroes)."""
    return _Shift.apply(x, group, [(r - 1) % stages for r in range(stages)])


def _from_last(x, group, stages):
    """Every stage receives the last stage's tensor."""
    return _Shift.apply(x, group, [stages - 1] * stages)


def _local(p, mesh, keep_pod: bool):
    """A parameter ``DTensor`` as this rank's local tensor: gathered over
    every axis but 'pod' (where ``keep_pod``, its pod shard: the stage's
    layers).  The gradient of the local tensor goes back summed over the
    pods (each adds what its stage used), averaged over 'data' (each data
    rank's loss is its own rows' mean) and as is over 'model'."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    full, grad = [], []
    for name in names:
        if name == "pod":
            full.append(Shard(0) if keep_pod else Replicate())
            grad.append(Shard(0) if keep_pod else Partial("sum"))
        elif name == "data":
            full.append(Replicate())
            grad.append(Partial("avg"))
        else:
            full.append(Replicate())
            grad.append(Replicate())
    return p.redistribute(mesh, full).to_local(grad_placements=grad)


def _pipeline_loss_ranks(params, cfg, batch, mesh, *, n_micro, remat):
    """(loss for the backward, metrics) of this rank's part of the
    pipelined loss on a mesh whose 'pod' axis holds the stages."""
    import torch.distributed as dist

    stages = mesh.size(mesh.mesh_dim_names.index("pod"))
    group = mesh.get_group("pod")
    stage = dist.get_rank(group)
    first, last = float(stage == 0), float(stage == stages - 1)
    per_stage = cfg.num_layers // stages

    local = {k: (tree_map(lambda p: _local(p, mesh, True), v)
                 if k == "layers" else
                 tree_map(lambda p: _local(p, mesh, False), v))
             for k, v in params.items()}
    tokens = batch["tokens"].to_local()
    labels = batch["labels"].to_local()
    B, S = tokens.shape
    _check(cfg, B, stages, n_micro)
    mb = B // n_micro

    x = tf._embed(local, cfg, tokens)
    D = x.shape[-1]
    xs = x.reshape(n_micro, mb, S, D)
    positions = tf._positions(mb, S, x.device)
    layers = tf._unstack(local["layers"], per_stage)
    stage_fn = _stage_fn(cfg, positions, remat)

    zero_mb = torch.zeros((mb, S, D), dtype=x.dtype, device=x.device)
    state = zero_mb
    outputs = []
    aux = tf._zero(x.device)
    for t in range(n_micro + stages - 1):
        inject = xs[t] if t < n_micro else zero_mb
        inp = first * inject + (1.0 - first) * _shift(state, group, stages)
        state, a = stage_fn(layers, inp)
        aux = aux + a
        if t >= stages - 1:
            outputs.append(_from_last(state, group, stages))
    x_out = torch.stack(outputs).reshape(B, S, D)
    ce = _ce(tf._unembed(local, cfg, x_out), labels)

    with torch.no_grad():
        aux_all = aux.detach().clone()
        dist.all_reduce(aux_all, group=group)
        stats = torch.stack([ce.detach().to(_F32), aux_all.to(_F32)])
        data = ("data" in mesh.mesh_dim_names
                and mesh.size(mesh.mesh_dim_names.index("data")) > 1)
        if data:
            dgroup = mesh.get_group("data")
            dist.all_reduce(stats, group=dgroup)
            stats = stats / dist.get_world_size(dgroup)
    return last * ce + aux, {"ce": stats[0], "loss": stats[0] + stats[1]}


def make_pipelined_train_step(cfg: ModelConfig, optimizer, *,
                              n_stages: int, n_micro: int,
                              remat: bool = True, grad_clip: float = 1.0,
                              mesh=None):
    """The pipelined train step.  With ``mesh`` None it runs the stages
    stacked on one process (plain tensors).  With a ``DeviceMesh`` whose
    'pod' axis has extent ``n_stages``, every rank calls it on ``DTensor``
    parameters (the layer stack ``Shard(0)`` over 'pod',
    :func:`stage_shardings`), optimizer state and a batch sharded over
    'data' only."""
    if mesh is not None:
        ext = mesh.size(mesh.mesh_dim_names.index("pod"))
        if ext != n_stages:
            raise ValueError(f"n_stages={n_stages} but the mesh's pod "
                             f"axis has extent {ext}")

    def train_step(params, opt_state, batch, lr_scale=1.0):
        if mesh is None:
            loss, metrics, grads = loss_and_grads(
                lambda p: pipeline_loss_fn(p, cfg, batch, n_stages=n_stages,
                                           n_micro=n_micro, remat=remat),
                params)
            report = loss.detach().to(_F32)
        else:
            set_manual_axes({"pod", "data", "model"})
            try:
                loss, metrics, grads = loss_and_grads(
                    lambda p: _pipeline_loss_ranks(
                        p, cfg, batch, mesh, n_micro=n_micro, remat=remat),
                    params)
            finally:
                set_manual_axes(set())
            report = metrics["loss"]
        with _mesh_context(params):
            new_params, new_opt, gnorm = clip_and_apply(
                optimizer, params, grads, opt_state, lr_scale, grad_clip)
        if _is_dtensor(gnorm):
            gnorm = gnorm.full_tensor()
        return new_params, new_opt, {"loss": report, "grad_norm": gnorm}
    return train_step


def stage_shardings(p_sh, params, cfg, mesh):
    """The pipeline's parameter shardings: the layer stack's leading
    (layer) dim over 'pod' (each pod holds, and reduces the gradients
    of, its own stage), the rest as ``p_sh`` -- the JAX package's dry-run
    ``_stage_shard``."""
    from repro_torch.dist.sharding import _map_with_path, sharding

    stages = mesh.size(mesh.mesh_dim_names.index("pod"))

    def fix(path, sh):
        leaf = params
        for k in path:
            leaf = leaf[k]
        if (path[0] == "layers" and leaf.ndim >= 1
                and leaf.shape[0] == cfg.num_layers
                and cfg.num_layers % stages == 0):
            spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
            spec[0] = "pod"
            return sharding(mesh, tuple(spec))
        return sh
    return _map_with_path(fix, p_sh)
