"""The port's dry run (``repro_torch.launch.dryrun``) on PyTorch's fake
process group: every kind of cell (train, prefill, decode) and every
variant of the train cell (base, sp, compressed, pipeline) at smoke
widths, on the production meshes' fake worlds of 256 ranks (data 32,
model 8) and 512 ranks (pod 2, data 32, model 8), nothing allocated.

The qwen3 cells take the smoke config with 8 heads and 8 key-value
heads (the production meshes' 'model' extent; the smoke config's 4 do not
divide it, and the full config's 16 do).  With heads or a sequence-
parallel stream split over 'model' on the three-axis mesh, DTensor's
sharding-strategy search (PyTorch 2.13) takes minutes an op: the other
families' cells and the ``sp`` variant run on the 256-rank world here.

Checked per cell: each rank's parameter and optimizer bytes are the
rules' exact share (the spec's sharded dims divided by their mesh
extents), every field of the JAX package's report is present (with the
port's ``cross_host`` / ``intra_host`` in place of its pod split), the
roofline uses the H100's published peaks and the named network rate,
and every local tensor is a meta tensor.  The JAX package is not run
here: its dry run needs 512 forced host devices, and the fields compared
are its report's names.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.configs import ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as ha  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

# The smoke configs' widths (d_model 64) divide 32; 64 sequences divide
# both worlds' data-parallel extents.
SHAPES = {"train": ShapeSpec("smoke_train", 64, 128, "train"),
          "prefill": ShapeSpec("smoke_prefill", 64, 64, "prefill"),
          "decode": ShapeSpec("smoke_decode", 64, 64, "decode")}

REPORT_KEYS = {"arch", "shape", "mesh", "params", "active_params",
               "seq_len", "global_batch", "kind", "multi_pod", "lower_s",
               "compile_s", "flops_per_chip", "bytes_per_chip",
               "collectives", "memory", "roofline", "variant"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter",
                   "all-to-all", "collective-permute", "count",
                   "cross_host", "intra_host", "total"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "roofline_fraction"}


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _no_world_left_behind():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _share(spec, shape, extents) -> int:
    div = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            div *= extents[a]
    n = int(np.prod(shape)) if shape else 1
    assert n % div == 0
    return n // div


def _exact_share_bytes(tree, mesh, spec_of) -> int:
    ext = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sum(_share(spec_of(path, x), tuple(x.shape), ext)
               * x.element_size()
               for path, x in tsh._leaves_with_paths(tree))


def _smoke(arch):
    cfg = get_smoke_config(arch)
    if arch == "qwen3-0.6b":
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=8,
                                  head_dim=8)
    return cfg


def _check_cell(arch, kind, multi_pod, variant, tmp_path):
    cfg = _smoke(arch)
    shape = SHAPES[kind]
    dryrun.start_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert mesh.size() == (512 if multi_pod else 256)
    tsh.set_activation_mesh(mesh)
    try:
        fn, args, meta = dryrun.build_cell(arch, shape, mesh, cfg=cfg,
                                           variant=variant)
        locals_ = [x.to_local() for x in tree_leaves(args)
                   if isinstance(x, torch.Tensor)]
        assert locals_ and all(x.device.type == "meta" for x in locals_)
        if kind == "train" and variant in ("base", "sp", "compressed"):
            # Each rank holds the rules' exact share of the parameters and
            # of the optimizer state.
            from repro_torch.models import transformer as tf
            params = tf.init_model(0, cfg, device="meta")
            want = _exact_share_bytes(
                params, mesh, lambda p, x: tsh._param_spec(p, x, mesh))
            assert dryrun.param_bytes_per_rank(args[0]) == want
            opt = dryrun._optimizer_for(arch).init(params)
            o_sh = dict(tsh._leaves_with_paths(tsh.opt_shardings(
                opt, params, tsh.param_shardings(params, mesh), mesh)))
            want_o = _exact_share_bytes(opt, mesh,
                                        lambda p, _: o_sh[p].spec)
            assert dryrun.param_bytes_per_rank(args[1]) == want_o
        out = fn(*args)
        outs = [x.to_local() if hasattr(x, "to_local") else x
                for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        # (the train step's lr_scale metric is a host scalar)
        assert all(x.device.type == "meta" for x in outs
                   if not (x.device.type == "cpu" and x.dim() == 0))
    finally:
        tsh.set_activation_mesh(None)
    rep = dryrun.run_cell(arch, shape, multi_pod, str(tmp_path),
                          variant=variant, cfg=cfg)
    assert REPORT_KEYS <= set(rep)
    assert COLLECTIVE_KEYS <= set(rep["collectives"])
    assert MEMORY_KEYS <= set(rep["memory"])
    assert ROOFLINE_KEYS <= set(rep["roofline"])
    assert rep["ranks"] == (512 if multi_pod else 256)
    assert rep["flops_per_chip"] > 0 and rep["bytes_per_chip"] > 0
    assert rep["memory"]["peak_bytes"] > 0
    assert (tmp_path / f"{arch}__{shape.name}__"
            f"{'pod2' if multi_pod else 'pod1'}"
            f"{'' if variant == 'base' else '__' + variant}.json").exists()
    return rep


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cell_of_each_kind_on_the_fake_world(kind, multi_pod, tmp_path):
    rep = _check_cell("qwen3-0.6b", kind, multi_pod, "base", tmp_path)
    if kind == "train":
        assert rep["collectives"]["count"] > 0


@pytest.mark.parametrize("variant,multi_pod", [
    ("sp", False), ("compressed", True), ("pipeline", True)])
def test_train_variants_on_the_fake_world(variant, multi_pod, tmp_path):
    rep = _check_cell("qwen3-0.6b", "train", multi_pod, variant, tmp_path)
    assert rep["variant"] == variant


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "mamba2-130m",
                                  "whisper-small", "minicpm3-4b"])
def test_other_families_train_on_the_fake_world(arch, tmp_path):
    _check_cell(arch, "train", False, "base", tmp_path)


def test_roofline_uses_the_h100_peaks():
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.NVLINK_BW, ha.NET_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    t = ha.roofline_terms(989e12, 3.35e12, 450e9, 50e9)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] == 2.0 and t["dominant"] == "collective"


def test_collective_bytes_split_by_host():
    recs = [("all-gather", 100, tuple(range(8))),
            ("all-reduce", 10, (0, 8, 16)),
            ("reduce-scatter", 1, (3, 4))]
    c = ha.collective_bytes(recs)
    assert (c["intra_host"], c["cross_host"], c["total"], c["count"]) == (
        101, 10, 111, 3)


def test_cli_runs_a_full_config_cell(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                 "--mesh", "single", "--report-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "ALL CELLS PASSED" in out
    assert (tmp_path / "mamba2-130m__decode_32k__pod1.json").exists()


def test_cli_counts_failures(tmp_path, capsys, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such cell")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                     "--mesh", "both", "--report-dir", str(tmp_path)])
    assert e.value.code == 1
    assert "2 FAILURES" in capsys.readouterr().out
