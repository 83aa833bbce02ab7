"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 200 --batch 8 --seq 128            # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 20 --batch 2 --seq 32 --device cpu

Wires together every layer of the port: config -> model -> train step ->
data pipeline -> checkpoint manager (atomic, auto-resume) -> watchdog +
straggler monitor -> spectral governor (the paper's eigenvalue-only
workflow driving the LR).

The governor's measurement is a product workload: every --spectral-every
steps one Krylov pass (``torch.func`` HVP on a --probe-batch sub-batch ->
Lanczos tridiagonal) feeds a k=1 sliced extremal solve.  With
--serve-monitor that solve is submitted through an EigensolverClient as a
``kind="edges"`` request -- same route key as plain range traffic -- and
is bit-identical to the direct path.  On the card the solve runs the
Sturm-count kernels (the bisection tree and the Newton sweep).  Probe
wall time lands on SOLVE_COUNTER's probe gauge and in the returned report
(probe_seconds / step_seconds is the monitoring overhead).

The HVP differentiates the loss at float32 copies of the parameters, cast
to each leaf's own dtype inside the loss: ``torch.func.jvp`` wants the
probe's float32 tangents to match the primal's dtype, so bfloat16
parameters (the full configs) take the cast.  At float32 parameters (the
smoke configs) the cast is the identity and the product the JAX
package's.

With --devices 1 (the default) the run is on one device: the card
unless --device cpu (or ``device="cpu"``).  With --devices N > 1 it is
one process per rank, N ranks in the process group (``torchrun
--nproc-per-node N -m repro_torch.launch.train --devices N``, or ranks
spawned with the group already initialized):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --devices 4 \
        --model-parallel 2                                 # four cards
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --devices 4 \
        --smoke --device cpu                               # gloo, CPU

Rank r runs on ``cuda:<LOCAL_RANK>`` (the CPU with --device cpu), over
--backend (NCCL on the card, gloo on the CPU; ranks that share a card
need gloo, NCCL refuses them).  The JAX package's mesh branch follows:
``make_mesh_for(N)``, ``set_activation_mesh``, parameters and optimizer
state distributed by ``param_shardings`` (``DTensor``s), and every rank
draws the global batch from the same seed and keeps its
``batch_sharding`` shard, so the data is the JAX package's and one
rank's.  The curvature probe gathers the parameters on every rank
(``full_tensor``); rank 0 runs the one-device probe on the sub-batch,
solves the k = 1 edges problem (through its ``EigensolverClient`` with
--serve-monitor) and broadcasts ``lr_scale`` and the largest eigenvalue,
so the ranks never disagree.  Checkpoints gather every leaf and rank 0
writes them (the other ranks wait at a barrier); a resumed run
distributes each restored leaf onto the current mesh (reshard-on-load).
Logs and the watchdog are rank 0's.

A resumed run replays the data from the step it resumes at (the JAX
package's driver restarts the stream at step 0; ROADMAP Queue 3); the
governor's state is not in the checkpoint, in either package.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.tune import resolve_device
from repro_torch.data import DataPipeline, SyntheticTokens
from repro_torch.dist.sharding import (batch_sharding, distribute_tree,
                                       opt_shardings, param_shardings,
                                       set_activation_mesh)
from repro_torch.launch.mesh import describe, make_mesh_for
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.spectral_adapt import SpectralGovernor
from repro_torch.runtime import StragglerMonitor, Watchdog
from repro_torch.spectral import lanczos_tridiag_batch, make_hvp
from repro_torch.spectral.slq import _rademacher_like, edges_from_tridiag
from repro_torch.tree import tree_map

_F32 = torch.float32


def krylov_tridiag(params, cfg, batch, probe, num_steps: int):
    """The Krylov tridiagonal (alpha (1, m), beta (1, m-1)) of the loss
    Hessian at ``params`` on ``batch`` from one ``probe`` (a tree shaped
    like ``params``, float32): m Lanczos steps of the HVP, differentiated
    at float32 copies of the parameters cast to their own dtypes inside
    the loss."""
    p32 = tree_map(lambda p: p.detach().to(_F32), params)

    def loss_of(pp):
        cast = tree_map(lambda x, p: x.to(p.dtype), pp, params)
        return tf.loss_fn(cast, cfg, batch)[0]

    hvp = make_hvp(loss_of, p32)
    # A 1-probe batch, in the parameters' key order (torch.func takes a
    # dict's order as part of its structure).
    stacked = tree_map(lambda _, x: x[None], params, probe)
    return lanczos_tridiag_batch(hvp, stacked, num_steps)


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--spectral-every", type=int, default=0,
                    help="probe curvature every N steps (0 = off)")
    ap.add_argument("--serve-monitor", action="store_true",
                    help="route curvature probes through the eigensolver "
                         "service (kind='edges') instead of direct solves")
    ap.add_argument("--probe-steps", type=int, default=8,
                    help="Lanczos steps per curvature probe")
    ap.add_argument("--probe-batch", type=int, default=2,
                    help="data sub-batch the probe HVP runs on")
    ap.add_argument("--target-sharpness", type=float, default=100.0)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to train on: 1, or the process group's "
                         "world size")
    ap.add_argument("--model-parallel", type=int, default=16,
                    help="largest 'model' extent of the mesh (--devices > 1)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend when --devices > 1 starts "
                         "the group: nccl on the card, gloo on the CPU")
    return ap


def _rank_device(device):
    """This rank's device: ``cuda:<LOCAL_RANK>`` on the card (which must
    be visible), the CPU where asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    visible = torch.cuda.device_count()
    if local >= visible:
        raise ValueError(
            f"LOCAL_RANK={local} but only {visible} CUDA device(s) are "
            f"visible; ranks that share a card set LOCAL_RANK to that "
            f"card's index and use --backend gloo")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _join_group(args, dev):
    """The process group of --devices N > 1: the one already initialized,
    or one started from torchrun's environment over --backend.  Its world
    size must be N."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                f"--devices {args.devices} needs a process group of "
                f"{args.devices} ranks: run under torchrun --nproc-per-node "
                f"{args.devices}, or from ranks that have joined one")
        backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size()
    if world != args.devices:
        raise ValueError(f"--devices {args.devices} but the process group "
                         f"has {world} ranks")
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        # Ranks sharing a card: DTensor's collectives go through host
        # memory (dist/host_staged.py).
        from repro_torch.dist import host_staged
        host_staged.install()
    return dist.get_rank()


def _broadcast_floats(values, dev):
    """Rank 0's floats on every rank."""
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=dev)
    dist.broadcast(t, 0)
    return [float(x) for x in t.cpu()]


def main(argv=None, *, device=None, before_step=None):
    """Run the trainer; returns its report.  ``before_step(step, params,
    batch)``, where given, is called on every rank just before each step
    with the parameters that step starts from (a check's hook)."""
    args = _parser().parse_args(argv)
    if args.devices < 1:
        raise ValueError(f"--devices must be >= 1, got {args.devices}")
    want = device if device is not None else args.device
    mesh, rank = None, 0
    if args.devices > 1:
        dev = _rank_device(want)
        rank = _join_group(args, dev)
    else:
        dev = resolve_device(want)
    on_card = dev.type == "cuda"
    lead = rank == 0

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tf.init_model(args.seed, cfg, device=dev)
    opt = get_optimizer(args.optimizer, lr=args.lr)
    opt_state = opt.init(params)
    shardings = None
    if args.devices > 1:
        mesh = make_mesh_for(args.devices,
                             model_parallel=args.model_parallel,
                             device_type=dev.type)
        set_activation_mesh(mesh)
        p_sh = param_shardings(params, mesh)
        shardings = (p_sh, opt_shardings(opt_state, params, p_sh, mesh))
        params, opt_state = distribute_tree((params, opt_state), shardings)
    step_fn = make_train_step(cfg, opt, remat=args.remat)
    pb = max(1, min(args.probe_batch, args.batch))

    def krylov(p, full_batch, step):
        # The probe's generator: a pure function of (seed, step), -1 for
        # the warm-up probe, as the JAX package's fold_in keys are.
        # (Called on rank 0 alone, with gathered parameters.)
        sub = {k: v[:pb] for k, v in full_batch.items()}
        seed = np.random.SeedSequence([args.seed, step + 1]).generate_state(
            1)[0]
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        probe = _rademacher_like(gen, p)
        alpha, beta = krylov_tridiag(p, cfg, sub, probe, args.probe_steps)
        if on_card:
            torch.cuda.synchronize(dev)
        return alpha, beta

    # --- fault tolerance ---------------------------------------------------
    ckpt = CheckpointManager(args.ckpt_dir, period=args.ckpt_every)
    restored, meta, start_step = ckpt.resume((params, opt_state),
                                             shardings=shardings)
    if restored is not None:
        params, opt_state = restored
        if lead:
            print(f"[train] resumed from step {start_step}")
    watchdog = (Watchdog(args.ckpt_dir + "/heartbeat.json",
                         timeout_s=600).start() if lead else None)
    straggler = StragglerMonitor()
    governor = SpectralGovernor(period=max(args.spectral_every, 1),
                                target_sharpness=args.target_sharpness)

    # --- data (from the step the run starts at) -----------------------------
    extra_fn = None
    if cfg.is_encdec:
        def extra_fn(step, shard, bsz):
            r = np.random.default_rng(np.random.SeedSequence([7, step, shard]))
            return {"frames": r.standard_normal(
                (bsz, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    pipe = DataPipeline(
        SyntheticTokens(cfg.vocab_size, args.seq, seed=args.seed),
        global_batch=args.batch, start_step=start_step,
        extra_fn=extra_fn).start()

    client = None
    if args.serve_monitor and args.spectral_every and lead:
        from repro_torch.serve import EigensolverClient
        # Prewarm the edges bucket so the first probe finds its plan (and,
        # on the card, the built kernels); batch=1 prewarms the (2*1
        # problems) launch shape a single trainer's probe flush produces.
        client = EigensolverClient(
            max_wait_us=100,
            prewarm=[{"kind": "edges", "n": args.probe_steps, "k": 1,
                      "batch": 1, "device": dev}])

    def to_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def to_mesh(batch):
        # Every rank holds the same global batch; each keeps its shard.
        if mesh is None:
            return batch
        return distribute_tree(batch, {
            k: batch_sharding(mesh, args.batch, v.ndim)
            for k, v in batch.items()})

    def gathered(p):
        return p if mesh is None else tree_map(lambda x: x.full_tensor(), p)

    it = iter(pipe)
    queued = None
    if args.spectral_every:
        # Warm the probe path (HVP + solve plan) outside the timed loop;
        # the batch is handed back to the first step afterwards.
        queued = to_device(next(it))
        full = gathered(params)
        if lead:
            alpha, beta = krylov(full, queued, -1)
            edges_from_tridiag(alpha, beta, k=1, client=client)
        del full

    lr_scale = 1.0
    losses, lr_scales, grad_norms = [], [], []
    step_seconds = 0.0   # excludes this run's first step (warm-up)
    probe_seconds = 0.0
    events = []
    probes = {"steps": [], "lam_max": [], "lr_scale": [], "wall_s": [],
              "solve_s": [], "tridiags": []}
    save_s = []
    first_step = True
    try:
        for step in range(start_step, args.steps):
            if queued is not None:
                host_batch, queued = queued, None
            else:
                host_batch = to_device(next(it))
            batch = to_mesh(host_batch)
            if before_step is not None:
                before_step(step, params, host_batch)
            if on_card:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 lr_scale)
            if on_card:
                ev[1].record()
                events.append(ev)
            loss = float(metrics["loss"])
            grad_norms.append(float(metrics["grad_norm"]))
            dt = time.time() - t0
            if not first_step:
                step_seconds += dt
            first_step = False
            straggler.record(step, dt)
            if watchdog is not None:
                watchdog.beat(step, loss=loss)
            losses.append(loss)
            lr_scales.append(lr_scale)

            if (args.spectral_every and step
                    and step % args.spectral_every == 0):
                # Eigenvalue-only curvature probe (the paper's workflow):
                # Lanczos + k=1 sliced extremal solve, optionally
                # serve-routed (bit-identical either way).
                tp = time.time()
                full = gathered(params)
                ts = tp
                if lead:
                    alpha, beta = krylov(full, host_batch, step)
                    ts = time.time()
                    lr_scale = governor.probe_tridiag(alpha, beta,
                                                      client=client)
                del full
                if mesh is not None:
                    lr_scale, lam = _broadcast_floats(
                        [lr_scale, governor.lam_max if lead else 0.0], dev)
                    if not lead:
                        # Mirror rank 0's governor.
                        alpha = beta = torch.zeros(0)
                        governor._lam_max = lam
                        governor.probes += 1
                probes["solve_s"].append(time.time() - ts)
                probes["wall_s"].append(time.time() - tp)
                probe_seconds += probes["wall_s"][-1]
                probes["steps"].append(step)
                probes["lam_max"].append(governor.lam_max)
                probes["lr_scale"].append(lr_scale)
                probes["tridiags"].append((alpha.cpu(), beta.cpu()))
                if lead:
                    print(f"[spectral] step={step} "
                          f"lam_max={governor.lam_max:.3e} "
                          f"lr_scale={lr_scale:.3f}")

            ts = time.time()
            if ckpt.maybe_save(step + 1, (params, opt_state),
                               meta={"loss": loss}) is not None:
                save_s.append(time.time() - ts)
            if step % args.log_every == 0 and lead:
                print(f"step={step:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
    finally:
        pipe.stop()
        if watchdog is not None:
            watchdog.stop()
        if mesh is not None:
            set_activation_mesh(None)

    serve_snap = None
    if client is not None:
        serve_snap = client.metrics()
        client.close()
    step_ms = None
    if on_card:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in events]
    if losses and lead:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"probes={governor.probes} probe_s={probe_seconds:.3f} "
              f"step_s={step_seconds:.3f}; "
              f"straggler report: {straggler.report()}")
    return {"losses": losses, "lr_scales": lr_scales,
            "lam_max": governor.lam_max, "probes": governor.probes,
            "probe_seconds": probe_seconds, "step_seconds": step_seconds,
            "steps": len(losses), "min_scale": governor.min_scale,
            "serve": serve_snap, "straggler": straggler.report(),
            "start_step": start_step, "probe_log": probes,
            "step_event_ms": step_ms, "ckpt_save_s": save_s,
            "device": str(dev), "state": (params, opt_state),
            "rank": rank, "mesh": None if mesh is None else describe(mesh),
            "grad_norms": grad_norms}


if __name__ == "__main__":
    main()
