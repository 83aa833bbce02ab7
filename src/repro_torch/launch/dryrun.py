"""Multi-pod dry run: every (arch x shape x mesh) cell's step on a fake
world of 256 or 512 ranks, nothing allocated (port of
``repro.launch.dryrun``).

For each cell this driver starts PyTorch's fake process group
(``FakeStore``, backend ``"fake"``: the counterpart of the JAX package's
512 forced host devices) at the production mesh's world size -- (data
32, model 8) = 256 ranks, or (pod 2, data 32, model 8) = 512 -- builds
abstract parameter / optimizer / input trees (``init_model(...,
device="meta")``: meta tensors), distributes them by the rules of
``dist/sharding.py`` as ``DTensor``s (each rank's local shard is a meta
tensor of its share), runs the step once as rank 0 under the counters of
``launch/hlo_analysis.py`` (per-rank FLOPs, bytes, collectives and peak
memory) and writes ``reports/dryrun_torch/<cell>.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

There is no compile step: ``lower_s`` is the time to build the cell's
abstract trees and shardings and run the step once (filling DTensor's
sharding-propagation cache, whose global-shape inference the counters
must not see), ``compile_s`` the time of the second run, under the
counters.  The JAX package's ``_calibrate_layers`` has no
counterpart: XLA's cost analysis counts a scanned layer stack's
while-loop body once, so it extrapolates from two unrolled compiles,
whereas the port loops over layers in Python and the counters see every
layer's ops.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.data.pipeline import synthetic_batch_specs
from repro_torch.dist.sharding import (batch_sharding,
                                       cache_shardings, distribute_tree,
                                       opt_shardings, param_shardings,
                                       set_activation_mesh,
                                       set_sequence_parallel, sharding)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.steps import (make_serve_prefill, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import adafactor, adamw
from repro_torch.tree import tree_leaves, tree_map

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")

# Large cells use Adafactor (factored second moment) to fit device memory.
_BIG_ARCHS = {"llama4-maverick-400b-a17b", "dbrx-132b", "deepseek-67b",
              "qwen2-vl-72b", "zamba2-7b"}

VARIANTS = ("base", "sp", "compressed", "pipeline")


def _optimizer_for(arch: str):
    if arch in _BIG_ARCHS:
        return adafactor(lr=1e-3)
    return adamw(lr=3e-4)


def _opt_shardings(opt_s, params_s, p_sh, mesh):
    """Optimizer-state shardings: match the parameter's sharding when the
    leaf shape equals the param shape (adam m/v); replicate factored
    statistics and scalars (``dist.sharding.opt_shardings``)."""
    return opt_shardings(opt_s, params_s, p_sh, mesh)


def start_world(ranks: int) -> None:
    """The fake process group of ``ranks`` ranks, this process rank 0 (a
    group of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == ranks and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def build_cell(arch: str, shape_name: str, mesh, cfg=None,
               variant: str = "base"):
    """Returns (fn, args, meta): ``fn(*args)`` runs the cell's step on
    ``DTensor``s of meta tensors distributed on ``mesh``.

    variant: the step functions of the JAX package's perf iterations:
      base       -- the production configuration
      sp         -- Megatron sequence-parallel residual stream
      compressed -- int8 error-feedback cross-pod gradient reduction
      pipeline   -- GPipe pipeline over the 'pod' axis
    """
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    params_s = tf.init_model(0, cfg, device="meta")
    p_sh = param_shardings(params_s, mesh)

    if shape.kind == "train":
        opt = _optimizer_for(arch)
        opt_s = opt.init(params_s)
        batch_s = synthetic_batch_specs(cfg, shape)
        b_sh = {k: batch_sharding(mesh, shape.global_batch, v.ndim)
                for k, v in batch_s.items()}
        if variant == "compressed":
            from repro_torch.dist.compression import init_compression_state
            from repro_torch.launch.steps import (_pod_view,
                                                  make_train_step_compressed)
            o_sh = _opt_shardings(opt_s, params_s, p_sh, mesh)
            P, S, B = distribute_tree((params_s, opt_s, batch_s),
                                      (p_sh, o_sh, b_sh))
            inner = mesh[tuple(mesh.mesh_dim_names[1:])]
            err = init_compression_state(
                tree_map(lambda p: _pod_view(p, inner), P)).error
            step = make_train_step_compressed(cfg, opt, mesh, remat=True)
            args = (P, S, B, err)
        elif variant == "pipeline":
            from repro_torch.launch.pipeline import (make_pipelined_train_step,
                                                     stage_shardings)
            names = mesh.mesh_dim_names
            n_stages = mesh.size(names.index("pod")) if "pod" in names else 2
            p_sh = stage_shardings(p_sh, params_s, cfg, mesh)
            o_sh = _opt_shardings(opt_s, params_s, p_sh, mesh)
            # batch over 'data' only: 'pod' is the stage axis here.
            b_sh = {k: sharding(mesh, ("data",) + (None,) * (v.ndim - 1))
                    for k, v in batch_s.items()}
            P, S, B = distribute_tree((params_s, opt_s, batch_s),
                                      (p_sh, o_sh, b_sh))
            step = make_pipelined_train_step(cfg, opt, n_stages=n_stages,
                                             n_micro=4, remat=True,
                                             mesh=mesh)
            args = (P, S, B)
        else:
            o_sh = _opt_shardings(opt_s, params_s, p_sh, mesh)
            P, S, B = distribute_tree((params_s, opt_s, batch_s),
                                      (p_sh, o_sh, b_sh))
            step = make_train_step(cfg, opt, remat=True)
            args = (P, S, B)
        fn = step
    elif shape.kind == "prefill":
        batch_s = synthetic_batch_specs(cfg, shape)
        P = distribute_tree(params_s, p_sh)
        tokens = distribute_tree(batch_s["tokens"],
                                 batch_sharding(mesh, shape.global_batch, 2))
        fn0 = make_serve_prefill(cfg, max_seq=shape.seq_len)
        if cfg.is_encdec:
            frames = distribute_tree(
                batch_s["frames"], batch_sharding(mesh, shape.global_batch, 3))
            args = (P, tokens, frames)
        else:
            args = (P, tokens)
        fn = fn0
    else:  # decode
        B = shape.global_batch
        cache_s = tf.init_cache(params_s, cfg, B, shape.seq_len)
        if cfg.is_encdec:
            # cross-attn caches exist only after prefill; build their specs
            ct = getattr(torch, cfg.compute_dtype)
            kv = (cfg.num_layers, B, cfg.encoder_seq_len, cfg.num_kv_heads,
                  cfg.head_dim)
            cache_s = {"self": cache_s["self"],
                       "cross": {k: torch.empty(kv, dtype=ct, device="meta")
                                 for k in ("k", "v")}}
        c_sh = cache_shardings(cache_s, cfg, mesh, B)
        P, C = distribute_tree((params_s, cache_s), (p_sh, c_sh))
        tokens = distribute_tree(
            torch.empty((B, 1), dtype=torch.int32, device="meta"),
            batch_sharding(mesh, B, 2))
        fn = make_serve_step(cfg)
        args = (P, C, tokens, shape.seq_len - 1)

    meta = {"arch": arch, "shape": shape.name, "mesh": describe(mesh),
            "params": int(cfg.num_params()),
            "active_params": int(cfg.active_params()),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "kind": shape.kind}
    return fn, args, meta


def param_bytes_per_rank(tree) -> int:
    """Bytes of one rank's local shards of a ``DTensor`` tree."""
    from torch.distributed.tensor import DTensor
    return sum((x.to_local() if isinstance(x, DTensor) else x).numel()
               * x.element_size() for x in tree_leaves(tree))


def run_cell(arch: str, shape_name, multi_pod: bool,
             report_dir: str = REPORT_DIR, variant: str = "base",
             cfg=None) -> dict:
    """One cell on the fake world; returns (and writes) its report.
    ``shape_name`` names one of ``SHAPES`` (or is a ``ShapeSpec``), and
    ``cfg`` replaces the arch's full config (the tests' smoke widths)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    start_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    set_activation_mesh(mesh)
    set_sequence_parallel(variant == "sp")
    try:
        t0 = time.time()
        fn, args, meta = build_cell(arch, shape_name, mesh, cfg=cfg,
                                    variant=variant)
        t_lower = time.time() - t0
        state_bytes = param_bytes_per_rank(args[:2])
        # A first run fills DTensor's sharding-propagation cache: its
        # shape inference runs ops on meta tensors of the global shapes,
        # which the counters (and MemTracker) would take for this rank's.
        t0 = time.time()
        fn(*args)
        t_warm = time.time() - t0
        counters = hlo_analysis.RankCounters()
        comm = CommDebugMode()
        tracker = MemTracker()
        tracker.track_external(*[x for x in tree_leaves(args)
                                 if isinstance(x, torch.Tensor)])
        t0 = time.time()
        with tracker, comm, counters:
            fn(*args)
        t_run = time.time() - t0
        analysis = hlo_analysis.analyze(counters, comm.get_comm_counts(),
                                        tracker)
    finally:
        set_activation_mesh(None)
        set_sequence_parallel(False)

    report = {**meta, "multi_pod": multi_pod, "ranks": mesh.size(),
              "lower_s": round(t_lower + t_warm, 2),
              "compile_s": round(t_run, 2),
              "state_bytes_per_rank": state_bytes, **analysis,
              "variant": variant}
    os.makedirs(report_dir, exist_ok=True)
    tag = f"{arch}__{report['shape']}__{'pod2' if multi_pod else 'pod1'}"
    if variant != "base":
        tag += f"__{variant}"
    with open(os.path.join(report_dir, tag + ".json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--report-dir", default=REPORT_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, SHAPES[shape_name]):
                print(f"SKIP {arch} x {shape_name} (long-context rule)")
                continue
            for mp in meshes:
                tag = (f"{arch} x {shape_name} x {'2pod' if mp else '1pod'}"
                       + (f" [{args.variant}]" if args.variant != "base"
                          else ""))
                try:
                    rep = run_cell(arch, shape_name, mp, args.report_dir,
                                   variant=args.variant)
                    r = rep["roofline"]
                    mem = rep["memory"]["peak_bytes"] / 2**30
                    print(f"OK   {tag}: run={rep['compile_s']:.0f}s "
                          f"peak={mem:.2f}GiB/rank "
                          f"dominant={r['dominant']} "
                          f"frac={r['roofline_fraction']:.2f}", flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
