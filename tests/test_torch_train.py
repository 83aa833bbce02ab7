"""The port's trainer and its layers (``repro_torch.launch``,
``repro_torch.data``, ``repro_torch.checkpoint``) on the CPU, held to the
JAX package's on the same inputs.

  * ``make_train_step``: 3 adamw steps from carried parameters and
    optimizer state on ``SyntheticTokens`` batches (qwen3, llama4's MoE
    and mamba2 smoke configs, float32): loss and grad_norm within rtol
    1e-4 of the JAX package's jitted step at every step;
  * the trainer's Krylov probe (``krylov_tridiag``) on the JAX package's
    own Rademacher probe (``repro.spectral.slq._rademacher_like``, the
    way tests/test_torch_spectral.py carries probes): alpha and beta
    within rtol 1e-4 (atol 1e-4 of the largest entry);
  * ``SyntheticTokens`` and ``DataPipeline`` equal bit for bit;
  * checkpoints cross both ways, float32 and bfloat16 parameter trees:
    the same manifest (keys, files, shapes, dtype names, CRC32s), the
    same file bytes, the same leaf bits; the port's own (params,
    opt_state) round trip bit for bit;
  * twins of tests/test_substrate.py's checkpoint tests (keep-N, a torn
    manifest skipped, corruption detected, kill-between-steps resume
    bit for bit), and the trainer resumed from a checkpoint == the
    uninterrupted trainer, bit for bit (the port replays the data from
    the resumed step);
  * a twin of tests/test_train_e2e.py on ``repro_torch.launch.train.main
    (..., device="cpu")``: convergence, the governor's probes and scales,
    the edges bucket's requests == probes + 1 and 0 errors.  It asserts
    no wall-clock ratio: the JAX package's 10% overhead bar is a
    host-timing flake (ROADMAP Queue 3 item 6), so the ratio is printed;
  * the serving driver's printed lines and ids;
  * the launch, model, data, checkpoint and config modules load no JAX
    and nothing of ``repro``; more than one device raises
    NotImplementedError naming ROADMAP Queue 1 item 4.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_tree as j_restore  # noqa: E402
from repro.checkpoint import save_tree as j_save  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data import SyntheticTokens as JTokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.spectral import hvp as jhvp  # noqa: E402
from repro.spectral import lanczos as jlz  # noqa: E402
from repro.spectral import slq as jslq  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    all_steps, latest_step, restore_tree,
                                    save_tree)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataPipeline, SyntheticTokens  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.tree import tree_from_numpy, tree_leaves  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

CPU = "cpu"
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    yield
    jax.clear_caches()


def _configs(arch, **changes):
    jc = dataclasses.replace(j_smoke(arch), **changes)
    tc = dataclasses.replace(get_smoke_config(arch), **changes)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _jax_params(jc, seed=0):
    return jax.jit(lambda k: jtf.init_model(k, jc))(jax.random.PRNGKey(seed))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bits(x):
    """A leaf's bytes, whichever package and dtype it comes from."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama4-maverick-400b-a17b",
                                  "mamba2-130m"])
def test_train_step_matches_repro(arch):
    jc, tc = _configs(arch)
    pj = _jax_params(jc)
    opt_j, opt_t = jopt.adamw(lr=1e-3), topt.adamw(lr=1e-3)
    sj = opt_j.init(pj)
    pt = params_from_numpy(_numpy(pj), CPU)
    st = tree_from_numpy(_numpy(sj), CPU)
    step_j = jax.jit(jsteps.make_train_step(jc, opt_j, remat=True))
    step_t = tsteps.make_train_step(tc, opt_t, remat=True)
    src = SyntheticTokens(tc.vocab_size, 32, seed=4)
    for s in range(3):
        b = src.batch(s, 0, 4)
        pj, sj, mj = step_j(pj, sj, {k: jnp.asarray(v) for k, v in
                                     b.items()}, 1.0)
        pt, st, mt = step_t(pt, st, {k: torch.from_numpy(v) for k, v in
                                     b.items()}, 1.0)
        for key in ("loss", "grad_norm"):
            _close(float(mt[key]), float(mj[key]))
    assert int(st["count"]) == 3 and st["count"].dtype == torch.int32


# ----------------------------------------------------------- Krylov probe


def test_krylov_probe_matches_repro_on_its_probe():
    jc, tc = _configs("qwen3-0.6b")
    pj = _jax_params(jc)
    b = SyntheticTokens(tc.vocab_size, 32, seed=5).batch(0, 0, 2)
    bj = {k: jnp.asarray(v) for k, v in b.items()}
    probe = jslq._rademacher_like(jax.random.PRNGKey(3), pj)
    steps = 4

    def j_krylov(p, probe):
        hvp = jhvp.make_hvp(lambda q: jtf.loss_fn(q, jc, bj)[0], p)
        return jlz.lanczos_tridiag_batch(
            hvp, jax.tree.map(lambda x: x[None], probe), steps)

    aj, bj_ = jax.jit(j_krylov)(pj, probe)
    at, bt = ttrain.krylov_tridiag(
        params_from_numpy(_numpy(pj), CPU), tc,
        {k: torch.from_numpy(v) for k, v in b.items()},
        tree_from_numpy(_numpy(probe), CPU), steps)
    assert tuple(at.shape) == (1, steps) and at.dtype == torch.float32
    _close(at.detach().numpy(), np.asarray(aj))
    _close(bt.detach().numpy(), np.asarray(bj_))


# -------------------------------------------------------------------- data


def test_data_matches_repro_bitwise():
    jsrc, tsrc = JTokens(1000, 24, seed=3), SyntheticTokens(1000, 24, seed=3)
    for step in range(4):
        for shard in range(2):
            a, b = jsrc.batch(step, shard, 3), tsrc.batch(step, shard, 3)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])

    def extra(step, shard, bsz):
        return {"step": np.full((bsz,), step, np.int32)}

    pipes = [cls(src, global_batch=4, num_shards=2, shard_id=1,
                 start_step=5, extra_fn=extra).start()
             for cls, src in ((JPipeline, jsrc), (DataPipeline, tsrc))]
    try:
        for a, b in zip(*(list(zip(range(3), iter(p))) for p in pipes)):
            for k in a[1]:
                np.testing.assert_array_equal(a[1][k], b[1][k])
            assert int(b[1]["step"][0]) == 5 + b[0]
    finally:
        for p in pipes:
            p.stop()


# -------------------------------------------------------------- checkpoint


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_crosses_packages_bitwise(tmp_path, dtype):
    jc, _ = _configs("qwen3-0.6b", param_dtype=dtype, compute_dtype=dtype)
    pj = _numpy(_jax_params(jc))
    like = params_from_numpy(pj, CPU)
    assert {x.dtype for x in tree_leaves(like)} == {
        torch.float32 if dtype == "float32" else torch.bfloat16}

    # The JAX package writes, the port reads and writes again.
    jpath = j_save(str(tmp_path / "j"), 7, pj, meta={"loss": 1.5})
    got, meta = restore_tree(str(tmp_path / "j"), 7, like)
    assert meta == {"loss": 1.5}
    assert [_bits(x) for x in tree_leaves(got)] == [
        _bits(x) for x in tree_leaves(like)]
    assert [x.dtype for x in tree_leaves(got)] == [
        x.dtype for x in tree_leaves(like)]
    tpath = save_tree(str(tmp_path / "t"), 7, got, meta={"loss": 1.5})
    assert _manifest(tpath) == _manifest(jpath)
    for entry in _manifest(tpath)["leaves"].values():
        with open(os.path.join(tpath, entry["file"]), "rb") as f1, \
                open(os.path.join(jpath, entry["file"]), "rb") as f2:
            assert f1.read() == f2.read()

    # The port writes, the JAX package reads.
    back, _ = j_restore(str(tmp_path / "t"), 7, pj)
    assert [_bits(x) for x in jax.tree.leaves(back)] == [
        _bits(x) for x in jax.tree.leaves(pj)]


def test_checkpoint_round_trips_params_and_opt_state(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              param_dtype="bfloat16")
    params = ttf.init_model(1, cfg, device=CPU)
    opt = topt.adamw()
    state = opt.init(params)
    state["count"] = state["count"] + 3
    tree = (params, state)
    save_tree(str(tmp_path), 2, tree)
    got, _ = restore_tree(str(tmp_path), 2, tree)
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[1]["count"]) == 3


def test_checkpoint_keep_n(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": torch.zeros(2)}
    for s in range(6):
        save_tree(d, s, tree, keep=3)
    assert all_steps(d) == [3, 4, 5]


def test_checkpoint_corruption_detected(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    path = save_tree(d, 1, tree)
    fn = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, fn))
    arr[0] += 1
    np.save(os.path.join(path, fn), arr)
    with pytest.raises(IOError, match="checksum"):
        restore_tree(d, 1, tree)


def test_torn_checkpoint_skipped(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"a": torch.zeros(2)}
    save_tree(d, 1, tree)
    save_tree(d, 2, tree)
    # tear the newest manifest
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write("{ torn")
    assert latest_step(d) == 1


def test_kill_between_steps_resume_identical_params(tmp_path):
    """A run killed after an arbitrary step and relaunched from its
    CheckpointManager lands on exactly the params of an uninterrupted
    run: restore is checksummed, and SyntheticTokens is addressed by
    (step, shard)."""
    d = str(tmp_path / "ckpt")
    src = SyntheticTokens(vocab_size=64, seq_len=8, seed=3)

    def step_fn(w, tokens):
        p = w["w"].detach().requires_grad_(True)
        loss = torch.mean((p[tokens] - 0.1) ** 2)
        (g,) = torch.autograd.grad(loss, [p])
        return {"w": (p - 0.5 * g).detach()}

    def run(total_steps, kill_at=None, ckpt_dir=None):
        params = {"w": torch.linspace(0.0, 1.0, 64, dtype=torch.float64)}
        start = 0
        if ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir, period=2)
            restored, _, start = mgr.resume(params)
            if restored is not None:
                params = restored
        for s in range(start, total_steps):
            tokens = torch.from_numpy(src.batch(s, 0, 4)["tokens"])
            params = step_fn(params, tokens)
            if ckpt_dir is not None:
                mgr.maybe_save(s + 1, params)
            if kill_at is not None and s + 1 == kill_at:
                return params      # "SIGKILL": manager just abandoned
        return params

    golden = run(11)
    run(11, kill_at=7, ckpt_dir=d)       # dies mid-run (last ckpt: step 6)
    resumed = run(11, ckpt_dir=d)        # relaunch resumes, finishes
    assert torch.equal(resumed["w"], golden["w"])


# ------------------------------------------------------------------ driver

SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--batch", "4", "--seq", "32",
         "--lr", "3e-3", "--log-every", "1000"]


def test_trainer_resumed_equals_uninterrupted_bitwise(tmp_path):
    full = ttrain.main(SMOKE + ["--steps", "6", "--ckpt-every", "3",
                                "--ckpt-dir", str(tmp_path / "a")],
                       device=CPU)
    ttrain.main(SMOKE + ["--steps", "3", "--ckpt-every", "3",
                         "--ckpt-dir", str(tmp_path / "b")], device=CPU)
    resumed = ttrain.main(SMOKE + ["--steps", "6", "--ckpt-every", "3",
                                   "--ckpt-dir", str(tmp_path / "b")],
                          device=CPU)
    assert resumed["start_step"] == 3 and resumed["steps"] == 3
    assert resumed["losses"] == full["losses"][3:]
    like = ttf.init_model(0, get_smoke_config("qwen3-0.6b"), device=CPU)
    like = (like, topt.adamw().init(like))
    a, _ = restore_tree(str(tmp_path / "a"), 6, like)
    b, _ = restore_tree(str(tmp_path / "b"), 6, like)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


E2E = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "85", "--batch", "8",
       "--seq", "128", "--lr", "3e-3", "--ckpt-every", "100000",
       "--log-every", "1000"]


def test_train_with_serve_monitor_converges_and_governs(tmp_path):
    off = ttrain.main(E2E + ["--ckpt-dir", str(tmp_path / "off")],
                      device=CPU)
    on = ttrain.main(E2E + ["--ckpt-dir", str(tmp_path / "on"),
                            "--spectral-every", "40", "--serve-monitor",
                            "--probe-steps", "4", "--probe-batch", "1",
                            "--target-sharpness", "2.0"], device=CPU)

    # Converges with the governor on (and the baseline does too).
    assert on["losses"][-1] < on["losses"][0]
    assert off["losses"][-1] < off["losses"][0]
    assert np.isfinite(on["losses"]).all()

    # The governor fired and controlled the LR: with the target below the
    # observed lam_max the scale leaves 1.0, and every applied scale stays
    # inside [min_scale, 1].
    assert on["probes"] >= 1
    scales = on["lr_scales"]
    assert all(on["min_scale"] <= s <= 1.0 for s in scales)
    assert min(scales) < 1.0
    assert on["lam_max"] > 2.0          # why the scale had to move

    # Monitoring overhead, reported and not gated (a host-timing ratio).
    print(f"monitor overhead (probe_s / step_s, CPU host wall): "
          f"{on['probe_seconds'] / on['step_seconds']:.1%}")

    # The probes went through the service: the edges bucket saw traffic
    # and finished clean (+1: the warm-up solve also rides the service).
    buckets = on["serve"]["buckets"]
    assert buckets["range/n4/k1/float64"]["requests"] == on["probes"] + 1
    assert sum(b["errors"] for b in buckets.values()) == 0

    # Off-run control: no probes, no service.
    assert off["probes"] == 0 and off["serve"] is None
    assert on["device"] == off["device"] == "cpu"
    assert on["step_event_ms"] is None        # no device timing on the CPU


def test_serve_driver_prints_and_generates(capsys):
    gen = tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--batch", "3",
                       "--prompt-len", "8", "--gen", "5"], device=CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] arch=qwen3-smoke prefill(8 toks)=")
    assert out[1] == f"[serve] sample generated ids: {gen[0][:12].tolist()}"
    assert gen.shape == (3, 5) and ((0 <= gen) & (gen < 256)).all()
    # The driver's ids are its parameters' greedy decode from its prompts.
    cfg = get_smoke_config("qwen3-0.6b")
    tokens, _ = tserve.prompts(cfg, 3, 8, 0, CPU)
    ids, logits, _, _ = tserve.greedy_generate(
        ttf.init_model(0, cfg, device=CPU), cfg, tokens, 5)
    np.testing.assert_array_equal(ids.numpy(), gen)
    assert len(logits) == 5


# ----------------------------------------------------------------- edges


def test_more_than_one_device_raises_not_implemented():
    # --devices 2 trains on a process group of two ranks
    # (tests/test_torch_mesh_train.py); with none joined and no torchrun
    # environment it raises before touching a device.
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        ttrain.main(SMOKE + ["--steps", "1", "--devices", "2"], device=CPU)


def test_launch_and_model_modules_import_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.data\n"
        "import repro_torch.checkpoint\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a) for a in ARCHS]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.main(SMOKE + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tserve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttf.init_model(0, get_smoke_config("qwen3-0.6b"))
