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

The run is on one device: the card unless --device cpu (or
``device="cpu"``).  Asking for more (--devices N > 1) raises
NotImplementedError: the mesh, parameter shardings and the compressed
cross-pod step are ROADMAP Queue 1 item 4.  A resumed run replays the
data from the step it resumes at (the JAX package's driver restarts the
stream at step 0; ROADMAP Queue 3); the governor's state is not in the
checkpoint, in either package.
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
                    help="devices to train on (only 1 is ported)")
    return ap


def main(argv=None, *, device=None):
    args = _parser().parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: the multi-device trainer (mesh, "
            f"parameter shardings, compressed cross-pod step) is not ported "
            f"to repro_torch yet (ROADMAP Queue 1 item 4)")
    dev = resolve_device(device if device is not None else args.device)
    on_card = dev.type == "cuda"

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tf.init_model(args.seed, cfg, device=dev)
    opt = get_optimizer(args.optimizer, lr=args.lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=args.remat)
    pb = max(1, min(args.probe_batch, args.batch))

    def krylov(p, full_batch, step):
        # The probe's generator: a pure function of (seed, step), -1 for
        # the warm-up probe, as the JAX package's fold_in keys are.
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
    restored, meta, start_step = ckpt.resume((params, opt_state))
    if restored is not None:
        params, opt_state = restored
        print(f"[train] resumed from step {start_step}")
    watchdog = Watchdog(args.ckpt_dir + "/heartbeat.json",
                        timeout_s=600).start()
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
    if args.serve_monitor and args.spectral_every:
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

    it = iter(pipe)
    queued = None
    if args.spectral_every:
        # Warm the probe path (HVP + solve plan) outside the timed loop;
        # the batch is handed back to the first step afterwards.
        queued = to_device(next(it))
        alpha, beta = krylov(params, queued, -1)
        edges_from_tridiag(alpha, beta, k=1, client=client)

    lr_scale = 1.0
    losses, lr_scales = [], []
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
                batch, queued = queued, None
            else:
                batch = to_device(next(it))
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
            dt = time.time() - t0
            if not first_step:
                step_seconds += dt
            first_step = False
            straggler.record(step, dt)
            watchdog.beat(step, loss=loss)
            losses.append(loss)
            lr_scales.append(lr_scale)

            if (args.spectral_every and step
                    and step % args.spectral_every == 0):
                # Eigenvalue-only curvature probe (the paper's workflow):
                # Lanczos + k=1 sliced extremal solve, optionally
                # serve-routed (bit-identical either way).
                tp = time.time()
                alpha, beta = krylov(params, batch, step)
                ts = time.time()
                lr_scale = governor.probe_tridiag(alpha, beta,
                                                  client=client)
                probes["solve_s"].append(time.time() - ts)
                probes["wall_s"].append(time.time() - tp)
                probe_seconds += probes["wall_s"][-1]
                probes["steps"].append(step)
                probes["lam_max"].append(governor.lam_max)
                probes["lr_scale"].append(lr_scale)
                probes["tridiags"].append((alpha.cpu(), beta.cpu()))
                print(f"[spectral] step={step} "
                      f"lam_max={governor.lam_max:.3e} "
                      f"lr_scale={lr_scale:.3f}")

            ts = time.time()
            if ckpt.maybe_save(step + 1, (params, opt_state),
                               meta={"loss": loss}) is not None:
                save_s.append(time.time() - ts)
            if step % args.log_every == 0:
                print(f"step={step:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
    finally:
        pipe.stop()
        watchdog.stop()

    serve_snap = None
    if client is not None:
        serve_snap = client.metrics()
        client.close()
    step_ms = None
    if on_card:
        torch.cuda.synchronize(dev)
        step_ms = [a.elapsed_time(b) for a, b in events]
    if losses:
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
            "device": str(dev), "state": (params, opt_state)}


if __name__ == "__main__":
    main()
