"""The port's multi-rank trainer on the CPU: ``launch.mesh``'s trainer
meshes, ``dist.sharding``'s rules, the grouped MoE dispatch, the int8
cross-pod step, GPipe, reshard-on-load, ``launch.train --devices N`` and
a batched solve split over devices.

The port runs one process per rank (``torch.distributed`` over gloo, a
``DeviceMesh`` of named axes, ``DTensor`` parameters); the JAX package is
single-controller GSPMD.  Held against the JAX package on the same
inputs:

  * ``mesh_shape_for``: the same shapes and errors over tests/test_dist.py's
    cases;
  * ``logical_param_specs``: the same spec tuple, leaf by leaf, for all
    ten full configs at five stand-in meshes, and ``_prune``, ``_dp_axes``
    and the cache specs;
  * ``moe_forward`` with G dispatch groups (G in 1, 2, 4): the same expert
    ids, slots and keep mask, and outputs at the models' tolerance;
  * ``_compress_one``: the int8 payload and residual bit for bit;
  * the sharded train step on four gloo ranks, mesh (data 2, model 2),
    against the JAX package's sharded step on four forced host devices
    (one subprocess: ``make_mesh_for(4, model_parallel=2)``) for a dense
    and a MoE smoke config, and the compressed and pipelined steps
    likewise -- per-step loss and grad norm within ``RTOL`` relative;
  * ``pipeline_forward`` on one process at tests/test_models.py's 2e-3;
  * a checkpoint of a (2, 2) run restores onto (1, 2) and onto one rank,
    and through the JAX package's ``restore_tree``, bit for bit.

Within the port: the four-rank run equals the one-rank run at ``RTOL``,
the multi-rank trainer's losses equal its one-rank CLI run's, and a
batched solve split over four CPU "devices" equals the unsplit solve bit
for bit.  Ranks start from a ``file://`` store under ``tmp_path`` (no
fixed port under pytest-xdist).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import mesh_shape_for as j_mesh_shape_for  # noqa: E402
from repro.models import layers as jnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import eigvalsh_tridiagonal_batch  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.dist import compression as tcomp  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import mesh_shape_for  # noqa: E402
from repro_torch.models import layers as tnn  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: E402,F401

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Per-step loss and grad norm of a float32 smoke config on four ranks
# against one device (either package): the reductions split over ranks
# add in another order.  Measured on the CPU: at most 2.3e-7 relative
# against the port's one-rank run, 1.5e-6 against the JAX package's
# sharded steps (the compressed step's grad norm).
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    jax.clear_caches()


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ------------------------------------------------------- mesh factorization


@pytest.mark.parametrize("devices,kw", [
    (1, {}), (48, {}), (6, {}), (12, {"model_parallel": 8}),
    (9, {"model_parallel": 4}), (7, {"model_parallel": 4}),
    (8, {"model_parallel": 2, "pods": 2}),
    (8, {"model_parallel": 2, "pods": 3}),
])
def test_mesh_shape_for_matches_repro(devices, kw):
    assert mesh_shape_for(devices, **kw) == j_mesh_shape_for(devices, **kw)


@pytest.mark.parametrize("devices,kw", [
    (0, {}), (-4, {}), (8, {"model_parallel": 0}), (8, {"pods": 0}),
])
def test_mesh_shape_for_raises_as_repro(devices, kw):
    with pytest.raises(ValueError) as want:
        j_mesh_shape_for(devices, **kw)
    with pytest.raises(ValueError) as got:
        mesh_shape_for(devices, **kw)
    assert str(got.value) == str(want.value)


def test_production_mesh_shapes_for_the_card():
    from repro_torch.launch import mesh as tmesh
    assert tmesh.PRODUCTION_SHAPE == (32, 8)
    assert tmesh.HOST_CARDS == tmesh.PRODUCTION_SHAPE[-1]
    assert tmesh.describe(SimpleNamespace(shape={"data": 32, "model": 8})) \
        == "data=32 x model=8"


# ------------------------------------------------------- sharding rules

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "32x8": {"data": 32, "model": 8},
          "2x32x8": {"pod": 2, "data": 32, "model": 8},
          "4x3": {"data": 4, "model": 3}}

_SHAPES = {}


def _abstract(arch):
    if arch not in _SHAPES:
        rng = jax.random.PRNGKey(0)
        _SHAPES[arch] = (
            jax.eval_shape(lambda: jtf.init_model(rng, j_config(arch))),
            ttf.init_model(0, get_config(arch), device="meta"))
    return _SHAPES[arch]


def _jax_specs(specs):
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_specs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logical_param_specs_match_repro(arch, mesh):
    jp, tp = _abstract(arch)
    m = SimpleNamespace(shape=MESHES[mesh])
    want = _jax_specs(jsh.logical_param_specs(jp, m))
    got = _port_specs(tsh.logical_param_specs(tp, m))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prune_dp_axes_and_cache_specs_match_repro(mesh):
    m = SimpleNamespace(shape=MESHES[mesh])
    for axes, shape in [(("model",), (8,)), (("model",), (6,)),
                        ((("pod", "data"), "model"), (64, 48)),
                        (("data", None, "model"), (32, 3, 24))]:
        assert tsh._prune(axes, shape, m) == jsh._prune(axes, shape, m)
    for size in (1, 2, 3, 16, 32, 64, 96, 128):
        assert tsh._dp_axes(m, size) == jsh._dp_axes(m, size)
    for arch in ("qwen3-0.6b", "mamba2-130m", "minicpm3-4b"):
        cfg_j, cfg_t = j_config(arch), get_config(arch)
        jp, tp = _abstract(arch)
        jc = jax.eval_shape(lambda: jtf.init_cache(jp, cfg_j, 64, 128))
        tc = ttf.init_cache(tp, cfg_t, 64, 128)
        abstract = jax.sharding.AbstractMesh(
            tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
        want = _jax_specs(jax.tree.map(
            lambda sh: sh.spec, jsh.cache_shardings(jc, cfg_j, abstract, 64),
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))
        got = _port_specs(tsh.cache_specs(tc, cfg_t, m, 64))
        assert got == want, arch


def test_placements_shard_a_dim_over_several_axes_major_first():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsh.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert tsh.placements((), mesh) == (Replicate(),) * 3


# ------------------------------------------------------- grouped MoE


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "dbrx-132b"])
def test_moe_forward_groups_match_repro(arch, G):
    jc, tc = j_smoke(arch), get_smoke_config(arch)
    pj = jax.jit(lambda k: jtf.init_model(k, jc))(jax.random.PRNGKey(3))
    moe_j = jax.tree.map(lambda a: a[0], pj["layers"]["moe"])
    moe_t = params_from_numpy(_numpy(moe_j), CPU)
    x = np.random.default_rng(G).standard_normal(
        (4, 16, jc.d_model)).astype(np.float32)
    T, E, k = 64, jc.moe_num_experts, jc.moe_top_k
    mesh = SimpleNamespace(shape={"data": G})
    jsh.set_activation_mesh(mesh)
    tsh.set_activation_mesh(mesh)
    try:
        yj, auxj = jnn.moe_forward(moe_j, jc, jnp.asarray(x))
        yt, auxt = tnn.moe_forward(moe_t, tc, torch.from_numpy(x))
        assert tnn.moe_groups(T) == G
    finally:
        jsh.set_activation_mesh(None)
        tsh.set_activation_mesh(None)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    # Routes: expert ids, slots and the keep mask of every group, equal.
    Tg = T // G
    cap = tnn.moe_capacity(tc, Tg)
    probs, gv, eid = tnn.moe_route(moe_t, tc, torch.from_numpy(x))
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(G, Tg, -1),
                        moe_j["router"])
    gvj, eidj = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    assert np.array_equal(eid.numpy().reshape(G, Tg, k), np.asarray(eidj))
    xs = torch.from_numpy(x).reshape(G, Tg, -1)
    for g in range(G):
        _, meta_t = tnn.moe_group_dispatch(
            xs[g], eid.reshape(G, -1)[g], gv.reshape(G, -1)[g], cap, E, k)
        gvn = gvj[g] / jnp.clip(jnp.sum(gvj[g], -1, keepdims=True), 1e-9)
        _, meta_j = jnn._moe_group_dispatch(
            jnp.asarray(x).reshape(G, Tg, -1)[g], eidj[g].reshape(-1),
            gvn.reshape(-1), cap, E)
        for a, b in zip(meta_t[:3] + meta_t[4:], meta_j[:3] + meta_j[4:]):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_one_group_moe_is_the_one_device_form():
    """G = 1 is the port's one-group dispatch: no mesh and a mesh of one
    data rank give the same bits."""
    tc = get_smoke_config("llama4-maverick-400b-a17b")
    p = ttf.init_model(0, tc, device=CPU)["layers"]["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, tc.d_model)).astype(np.float32))
    y0, a0 = tnn.moe_forward(p, tc, x)
    tsh.set_activation_mesh(SimpleNamespace(shape={"data": 1, "model": 4}))
    try:
        y1, a1 = tnn.moe_forward(p, tc, x)
    finally:
        tsh.set_activation_mesh(None)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


# ------------------------------------------------------- int8 compression


def test_compress_one_matches_repro_bitwise():
    from repro.compat import shard_map
    from jax.sharding import PartitionSpec as P
    rng = np.random.default_rng(0)
    g = rng.standard_normal(300).astype(np.float32) * 3
    err = rng.standard_normal(300).astype(np.float32) * 1e-2
    mesh = jax.make_mesh((1,), ("pod",))
    mj, ej = shard_map(lambda a, b: jcomp._compress_one(a, b, "pod"),
                       mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                       check_vma=False)(jnp.asarray(g), jnp.asarray(err))
    mt, et = tcomp._compress_one(torch.from_numpy(g), torch.from_numpy(err),
                                 None)
    assert mt.numpy().tobytes() == np.asarray(mj).tobytes()
    assert et.numpy().tobytes() == np.asarray(ej).tobytes()


def test_compressed_mean_over_two_gloo_ranks(tmp_path):
    mean, payloads = ranks.run_ranks(2, ranks.compressed_mean_ranks,
                                     tmp_path, 7)
    want = (payloads[0] + payloads[1]) / 2
    np.testing.assert_array_equal(mean, want.astype(np.float32))


# ------------------------------------------------------- vs repro's steps

_REPRO_STEPS = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import save_tree
from repro.configs import get_smoke_config
from repro.data import SyntheticTokens
from repro.dist.compression import init_compression_state
from repro.dist.sharding import param_shardings, set_activation_mesh
from repro.launch.mesh import make_mesh_for
from repro.launch.pipeline import make_pipelined_train_step
from repro.launch.steps import make_train_step, make_train_step_compressed
from repro.models import transformer as tf
from repro.optim.optimizers import adamw

arch, ckpt, kinds, out = sys.argv[1], sys.argv[2], sys.argv[3].split(","), sys.argv[4]
cfg = get_smoke_config(arch)
params = jax.jit(lambda k: tf.init_model(k, cfg))(jax.random.PRNGKey(0))
save_tree(ckpt, 0, params)
src = SyntheticTokens(cfg.vocab_size, 16, seed=4)
batches = [{k: jnp.asarray(v) for k, v in src.batch(s, 0, 4).items()}
           for s in range(3)]
opt = adamw(lr=1e-3)
res = {}
for kind in kinds:
    if kind == "base":
        mesh = make_mesh_for(4, model_parallel=2)
    elif kind == "compressed":
        mesh = make_mesh_for(4, model_parallel=2, pods=2)
    else:
        mesh = make_mesh_for(4, model_parallel=1, pods=2)
    set_activation_mesh(mesh)
    p, s = params, opt.init(params)
    losses, norms = [], []
    if kind == "base":
        p_sh = param_shardings(p, mesh)
        step = jax.jit(make_train_step(cfg, opt, remat=True),
                       in_shardings=(p_sh, None, None))
        p = jax.device_put(p, p_sh)
        for b in batches:
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    elif kind == "compressed":
        step = jax.jit(make_train_step_compressed(cfg, opt, mesh, remat=True))
        err = init_compression_state(p).error
        for b in batches[:2]:
            p, s, m, err = step(p, s, b, err)
            losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    else:
        step = jax.jit(make_pipelined_train_step(cfg, opt, n_stages=2,
                                                 n_micro=2, remat=True))
        for b in batches[:2]:
            p, s, m = step(p, s, b)
            losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    set_activation_mesh(None)
    res[kind] = [losses, norms]
json.dump(res, open(out, "w"))
"""


def _repro_steps(tmp_path, arch, kinds):
    """The JAX package's sharded steps on four forced host devices; its
    initial parameters are checkpointed for the port's ranks."""
    ckpt = str(tmp_path / f"init_{arch}")
    out = tmp_path / f"repro_{arch}.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REPRO_STEPS, arch, ckpt, ",".join(kinds),
         str(out)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ckpt, json.loads(out.read_text())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-maverick-400b-a17b"])
def test_four_rank_train_step_matches_repro(tmp_path, arch):
    ckpt, want = _repro_steps(tmp_path, arch, ["base"])
    losses, norms, local = ranks.run_ranks(
        4, ranks.train_ranks, tmp_path, arch, ckpt, 3, 4, 16, 2)
    assert _rel(losses, want["base"][0]) <= RTOL
    assert _rel(norms, want["base"][1]) <= RTOL
    # The rules shard: some leaf is split over both mesh axes.
    cfg = get_smoke_config(arch)
    full = [tuple(x.shape) for x in
            tree_leaves(ttf.init_model(0, cfg, device="meta"))]
    shrink = [np.prod(f) // max(1, np.prod(s)) for f, s in zip(full, local)]
    assert max(shrink) == 4


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-maverick-400b-a17b"])
def test_four_rank_train_step_matches_one_rank(tmp_path, arch):
    from repro_torch.checkpoint.manager import save_tree
    ckpt = str(tmp_path / "init")
    save_tree(ckpt, 0, ttf.init_model(2, get_smoke_config(arch), device=CPU))
    losses, norms, _ = ranks.run_ranks(
        4, ranks.train_ranks, tmp_path, arch, ckpt, 3, 4, 16, 2)
    # One rank with the four-rank run's two MoE dispatch groups.
    one_l, one_n, _ = ranks.run_ranks(
        1, ranks.train_ranks, tmp_path, arch, ckpt, 3, 4, 16, 1, None, 2)
    assert _rel(losses, one_l) <= RTOL
    assert _rel(norms, one_n) <= RTOL


def test_compressed_step_matches_repro(tmp_path):
    arch = "qwen3-0.6b"
    ckpt, want = _repro_steps(tmp_path, arch, ["compressed"])
    c_l, c_n, gap = ranks.run_ranks(4, ranks.compressed_ranks, tmp_path,
                                    arch, ckpt, 2, 4, 16)
    assert _rel(c_l, want["compressed"][0]) <= RTOL
    assert _rel(c_n, want["compressed"][1]) <= RTOL
    # Each rank's int8 payload plus its residual is its float32 gradient,
    # and the mean is the pods' average payload.
    assert gap <= 1e-6


def test_pipelined_step_matches_repro(tmp_path):
    arch = "qwen3-0.6b"
    ckpt, want = _repro_steps(tmp_path, arch, ["pipeline"])
    p_l, p_n = ranks.run_ranks(4, ranks.pipeline_ranks, tmp_path, arch,
                               ckpt, 2, 4, 16, 2)
    assert _rel(p_l, want["pipeline"][0]) <= RTOL
    assert _rel(p_n, want["pipeline"][1]) <= RTOL


def test_pipeline_forward_one_process_matches_repro():
    jc, tc = j_smoke("qwen3-0.6b"), get_smoke_config("qwen3-0.6b")
    pj = jax.jit(lambda k: jtf.init_model(k, jc))(jax.random.PRNGKey(0))
    pt = params_from_numpy(_numpy(pj), CPU)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (4, 16),
                                             dtype=np.int32)
    lj, _ = jpipe.pipeline_forward(pj, jc, jnp.asarray(toks), n_stages=2,
                                   n_micro=2)
    lt, _ = tpipe.pipeline_forward(pt, tc, torch.from_numpy(toks),
                                   n_stages=2, n_micro=2)
    ref, _ = ttf.forward(pt, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(lt.detach().numpy(), ref.detach().numpy(),
                               atol=2e-3, rtol=2e-3)


# ------------------------------------------------------- reshard-on-load


def test_reshard_on_load_across_meshes_and_packages(tmp_path):
    from repro.checkpoint.manager import restore_tree as j_restore
    from repro_torch.checkpoint.manager import restore_tree
    from repro_torch.checkpoint.manager import save_tree
    from repro_torch.optim.optimizers import adamw
    arch = "qwen3-0.6b"
    cfg = get_smoke_config(arch)
    init = tmp_path / "init"
    save_tree(str(init), 0, ttf.init_model(5, cfg, device=CPU))
    run = tmp_path / "run"
    ranks.run_ranks(4, ranks.train_ranks, tmp_path, arch, str(init), 2, 4,
                    16, 2, str(run))
    like = (ttf.init_model(0, cfg, device=CPU),
            adamw(lr=1e-3).init(ttf.init_model(0, cfg, device=CPU)))
    saved, _ = restore_tree(str(run), 2, like)
    want = [(str(x.dtype), x.contiguous().reshape(-1).view(torch.uint8)
             .numpy().tobytes()) for x in tree_leaves(saved)]
    for world, mp in ((2, 2), (1, 1)):
        got = ranks.run_ranks(world, ranks.restore_ranks, tmp_path, arch,
                              str(run), 2, mp)
        assert got == want, (world, mp)
    jtree, _ = j_restore(str(run), 2, _like_j(arch))
    jbytes = [np.asarray(x).tobytes() for x in jax.tree.leaves(jtree)]
    assert jbytes == [b for _, b in want]


def _like_j(arch):
    from repro.optim.optimizers import adamw as j_adamw
    p = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                              j_smoke(arch)))
    return (p, jax.eval_shape(lambda: j_adamw(lr=1e-3).init(p)))


# ------------------------------------------------------- the trainer CLI

SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--batch", "4",
         "--seq", "16", "--log-every", "100"]


def test_trainer_cli_four_ranks_equals_one_rank(tmp_path):
    argv = SMOKE + ["--ckpt-dir", str(tmp_path / "ck4"), "--devices", "4",
                    "--model-parallel", "2", "--spectral-every", "2",
                    "--probe-steps", "4", "--probe-batch", "1"]
    l4, n4, s4 = ranks.run_ranks(4, ranks.trainer_cli_ranks, tmp_path, argv)
    one = ttrain.main(SMOKE + ["--ckpt-dir", str(tmp_path / "ck1"),
                               "--spectral-every", "2", "--probe-steps", "4",
                               "--probe-batch", "1"], device=CPU)
    assert _rel(l4, one["losses"]) <= RTOL
    assert _rel(n4, one["grad_norms"]) <= RTOL
    assert s4 == one["lr_scales"]


def test_devices_against_a_mismatched_world_raises(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            ttrain.main(SMOKE + ["--devices", "2", "--ckpt-dir",
                                 str(tmp_path / "ck")], device=CPU)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- split batch solve


def test_batch_split_over_devices_equals_unsplit(monkeypatch):
    rng = np.random.default_rng(11)
    D, E = rng.standard_normal((8, 300)), rng.standard_normal((8, 299))
    one = eigvalsh_tridiagonal_batch(D, E, return_boundary=True, device=CPU)
    assert tplan._batch_sharding(8, torch.device(CPU)) is None
    monkeypatch.setattr(tplan, "visible_devices", lambda t: [CPU] * 4)
    assert tplan._batch_sharding(8, torch.device(CPU)) == (CPU,) * 4
    assert tplan._batch_sharding(2, torch.device(CPU)) == (CPU,) * 2
    split = eigvalsh_tridiagonal_batch(D, E, return_boundary=True,
                                       device=CPU)
    for a, b in zip((one.eigenvalues, one.blo, one.bhi,
                     *one.kprime_per_level),
                    (split.eigenvalues, split.blo, split.bhi,
                     *split.kprime_per_level)):
        assert torch.equal(a, b)
