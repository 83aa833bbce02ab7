"""Gloo ranks for the multi-rank CPU tests of the port
(``tests/test_torch_mesh_train.py``).

``run_ranks(world, fn, tmp_path, *args)`` spawns ``world`` processes that
join one gloo group through a ``file://`` store under ``tmp_path`` (no
fixed port: pytest-xdist runs several files at once), pin one torch
thread each, call ``fn(rank, world, *args)`` and hand back rank 0's
return value.  This module imports torch and the port only, so a rank
starts in a few seconds.
"""

from __future__ import annotations

import os
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _entry(rank, world, store, fn, args, queue):
    torch.set_num_threads(1)
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, fn, tmp_path, *args, timeout: float = 240.0):
    """Rank 0's result of ``fn`` run on ``world`` gloo ranks; raises with
    the first failing rank's traceback."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}")
    if os.path.exists(store):
        os.remove(store)
    procs = [ctx.Process(target=_entry,
                         args=(r, world, store, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return results[0]


# ----------------------------------------------------------- rank bodies


def _batches(cfg, steps, batch, seq, seed=4):
    from repro_torch.data import SyntheticTokens
    src = SyntheticTokens(cfg.vocab_size, seq, seed=seed)
    return [{k: torch.from_numpy(v) for k, v in src.batch(s, 0, batch).items()}
            for s in range(steps)]


def _restore_params(arch, ckpt):
    from repro_torch.checkpoint.manager import restore_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    cfg = get_smoke_config(arch)
    like = tf.init_model(0, cfg, device="cpu")
    return cfg, restore_tree(ckpt, 0, like)[0]


def train_ranks(rank, world, arch, ckpt, steps, batch, seq, model_parallel,
                save_dir=None, groups=None):
    """``steps`` adamw steps (lr 1e-3) of the smoke config from the
    parameters checkpointed at ``ckpt`` step 0, on a (data, model) mesh of
    ``world`` ranks; returns (losses, grad norms, local shard shapes of
    the parameters).  With ``save_dir`` the final state is checkpointed
    there (gathered, rank 0 writing).  ``groups`` gives a one-rank run the
    MoE dispatch groups of a mesh with that data extent (a stand-in
    activation mesh; the constraints leave plain tensors alone)."""
    from repro_torch.checkpoint.manager import save_tree
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import tree_leaves

    cfg, params = _restore_params(arch, ckpt)
    opt = adamw(lr=1e-3)
    state = opt.init(params)
    mesh = make_mesh_for(world, model_parallel=model_parallel,
                         device_type="cpu")
    if groups:
        from types import SimpleNamespace
        sh.set_activation_mesh(SimpleNamespace(shape={"data": groups}))
    else:
        sh.set_activation_mesh(mesh)
    try:
        p_sh = sh.param_shardings(params, mesh)
        shardings = (p_sh, sh.opt_shardings(state, params, p_sh, mesh))
        P, S = sh.distribute_tree((params, state), shardings)
        step = make_train_step(cfg, opt, remat=True)
        losses, norms = [], []
        for b in _batches(cfg, steps, batch, seq):
            B = sh.distribute_tree(b, {k: sh.batch_sharding(mesh, batch, 2)
                                       for k in b})
            P, S, m = step(P, S, B, 1.0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        local = [tuple(x.to_local().shape) for x in tree_leaves(P)]
        if save_dir is not None:
            save_tree(save_dir, steps, (P, S))
    finally:
        sh.set_activation_mesh(None)
    return losses, norms, local


def restore_ranks(rank, world, arch, ckpt_dir, step, model_parallel):
    """Restore a (params, adamw state) checkpoint onto a (data, model)
    mesh of ``world`` ranks (reshard-on-load); returns every leaf's whole
    value, gathered, as numpy bytes with its dtype."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import tree_leaves

    cfg = get_smoke_config(arch)
    params = tf.init_model(1, cfg, device="cpu")
    state = adamw(lr=1e-3).init(params)
    mesh = make_mesh_for(world, model_parallel=model_parallel,
                         device_type="cpu")
    p_sh = sh.param_shardings(params, mesh)
    shardings = (p_sh, sh.opt_shardings(state, params, p_sh, mesh))
    tree, _, got = CheckpointManager(ckpt_dir).resume((params, state),
                                                      shardings=shardings)
    assert got == step, (got, step)
    out = []
    for x in tree_leaves(tree):
        full = x.full_tensor().contiguous().reshape(-1)
        out.append((str(full.dtype), full.view(torch.uint8).numpy().tobytes()))
    return out


def compressed_ranks(rank, world, arch, ckpt, steps, batch, seq):
    """The compressed step on a (pod 2, data 1, model 2) mesh: (losses,
    grad norms, the largest relative gap, over all ranks and leaves, on
    the first step, of (a) this rank's int8 payload plus its new residual
    against its own float32 gradient and (b) the mean against the pods'
    average payload)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.dist.compression import (_QMAX, CompressionState,
                                              compressed_cross_pod_mean,
                                              init_compression_state)
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.steps import (_pod_view, loss_and_grads,
                                          make_train_step_compressed)
    from repro_torch.models import transformer as tf
    from repro_torch.optim.optimizers import adamw
    from repro_torch.tree import tree_leaves, tree_map

    cfg, params = _restore_params(arch, ckpt)
    opt = adamw(lr=1e-3)
    state = opt.init(params)
    mesh = make_mesh_for(world, model_parallel=2, pods=2, device_type="cpu")
    inner = mesh[("data", "model")]
    pods = mesh.get_group("pod")
    sh.set_activation_mesh(mesh)
    try:
        p_sh = sh.param_shardings(params, mesh)
        P, S = sh.distribute_tree(
            (params, state), (p_sh, sh.opt_shardings(state, params, p_sh,
                                                     mesh)))
        err = init_compression_state(
            tree_map(lambda p: _pod_view(p, inner), P)).error
        step = make_train_step_compressed(cfg, opt, mesh, remat=True)
        losses, norms, gap = [], [], 0.0
        for i, b in enumerate(_batches(cfg, steps, batch, seq)):
            B = sh.distribute_tree(b, {k: sh.batch_sharding(mesh, batch, 2)
                                       for k in b})
            if i == 0:
                lb = {k: _pod_view(v, inner) for k, v in B.items()}
                sh.set_manual_axes({"pod"})
                try:
                    from torch.distributed.tensor.experimental import \
                        implicit_replication
                    with implicit_replication():
                        _, _, g = loss_and_grads(
                            lambda p: tf.loss_fn(p, cfg, lb, remat=True),
                            tree_map(lambda p: _pod_view(p, inner), P))
                        mean, new = compressed_cross_pod_mean(
                            g, CompressionState(err), pods)
                        for a, e, w in zip(tree_leaves(mean),
                                           tree_leaves(new.error),
                                           tree_leaves(g)):
                            w32 = w.to(torch.float32)
                            scale = torch.clamp_min(
                                torch.amax(torch.abs(w32)) / _QMAX,
                                torch.finfo(torch.float32).tiny)
                            deq = torch.clamp(torch.round(w32 / scale),
                                              -_QMAX, _QMAX) * scale
                            deq, e, w32, a = (x.to_local() for x in
                                              (deq, e, w32, a))
                            top = float(w32.abs().max()) or 1.0
                            gap = max(gap, float((deq + e - w32).abs().max())
                                      / top)
                            avg = deq.clone()
                            dist.all_reduce(avg, group=pods)
                            avg = avg / dist.get_world_size(pods)
                            # the mean comes back in the gradient's dtype
                            gap = max(gap, float((a - avg.to(a.dtype))
                                                 .abs().max()))
                finally:
                    sh.set_manual_axes(set())
            P, S, m, err = step(P, S, B, err, 1.0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        sh.set_activation_mesh(None)
    gaps = torch.tensor([gap])
    dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
    return losses, norms, float(gaps[0])


def pipeline_ranks(rank, world, arch, ckpt, steps, batch, seq, n_micro):
    """The pipelined step on a (pod 2, data 2, model 1) mesh, stage s on
    pod rank s: (losses, grad norms)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.pipeline import (make_pipelined_train_step,
                                             stage_shardings)
    from repro_torch.optim.optimizers import adamw

    cfg, params = _restore_params(arch, ckpt)
    opt = adamw(lr=1e-3)
    state = opt.init(params)
    mesh = make_mesh_for(world, model_parallel=1, pods=2, device_type="cpu")
    sh.set_activation_mesh(mesh)
    try:
        p_sh = stage_shardings(sh.param_shardings(params, mesh), params,
                               cfg, mesh)
        P, S = sh.distribute_tree(
            (params, state), (p_sh, sh.opt_shardings(state, params, p_sh,
                                                     mesh)))
        step = make_pipelined_train_step(cfg, opt, n_stages=2,
                                         n_micro=n_micro, remat=True,
                                         mesh=mesh)
        losses, norms = [], []
        for b in _batches(cfg, steps, batch, seq):
            B = sh.distribute_tree(b, {k: sh.sharding(mesh, ("data", None))
                                       for k in b})
            P, S, m = step(P, S, B, 1.0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        sh.set_activation_mesh(None)
    return losses, norms


def compressed_mean_ranks(rank, world, seed):
    """``compressed_cross_pod_mean`` of a random gradient per rank over
    the world group: (mean, every rank's dequantized payload)."""
    import numpy as np

    from repro_torch.dist.compression import (compressed_cross_pod_mean,
                                              init_compression_state)
    g = {"w": torch.from_numpy(np.random.default_rng(
        seed + rank).standard_normal(257).astype("float32"))}
    state = init_compression_state(g)
    mean, new = compressed_cross_pod_mean(g, state, dist.group.WORLD)
    deq = g["w"] - new.error["w"]
    payloads = [torch.empty_like(deq) for _ in range(world)]
    dist.all_gather(payloads, deq)
    return mean["w"].numpy(), [p.numpy() for p in payloads]


def trainer_cli_ranks(rank, world, argv):
    """``launch.train.main(argv)`` on this rank (the group already
    joined); returns (losses, grad norms, lr scales)."""
    from repro_torch.launch import train
    rep = train.main(argv, device="cpu")
    return rep["losses"], rep["grad_norms"], rep["lr_scales"]
