"""The port's distributed conquer on the CPU: ``mesh=`` and
``compress_halo=`` of the full-spectrum solve, ``repro_torch.dist`` and
``launch.mesh.make_solver_mesh``.

The port drives every shard from one process, as the JAX package's
``shard_map`` does; a mesh may name one device several times, so
``make_solver_mesh(P, devices=["cpu"] * P)`` runs P shards here.  Held
against the JAX package:

  * ``quantize_lanes`` gives its int8 payload and float32 scale bit for
    bit, and the root-window solve equals its window solve at the kernel
    bar (``repro.kernels.secular_roots``: about machine precision);
  * the sharded solve is within 64 eps * max(1, ||T||_inf) of its sharded
    solve (the conformance bar; one subprocess with four forced host
    devices, the JAX package's own way of getting P devices on a CPU).

Within the port, as tests/test_dist.py holds the JAX package: the sharded
solve equals the single-device one bit for bit (rows too, and with
``fused=False``), compressed rows stay within 0.05 ||T||, same-mesh
traffic builds no new plan, the plan cache counts mesh buckets, a served
flush on a sharded route equals the sync call, and the routing errors
mirror ``repro.core.plan._resolve_shards``.  Bit-identity on the CPU
assumes one torch thread (the module fixture): ATen splits a reduction
over threads by the number of rows, which differs between a shard's
lanes and the whole level's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import FAMILIES, make_family  # noqa: E402
from repro.core import clear_plan_cache as j_clear_plan_cache  # noqa: E402
from repro.core import secular as jsec  # noqa: E402
from repro.dist import compression as jcomp  # noqa: E402
from repro_torch.core import (EXECUTOR_TRACES, clear_plan_cache,  # noqa: E402
                              eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch, plan_cache_stats)
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.dist import (dequantize_lanes, gather_lanes,  # noqa: E402
                              gather_tree_state, halo_from_left,
                              quantize_lanes)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import describe, make_solver_mesh  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401

EPS = np.finfo(np.float64).eps
CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_executables():
    # The JAX reference compiles executables here; XLA:CPU keeps each
    # one's memory mappings for the life of the process (see
    # tests/test_torch_bisect.py).
    yield
    j_clear_plan_cache()
    jax.clear_caches()


def _mesh(P):
    return make_solver_mesh(P, devices=[CPU] * P)


def _tinf(d, e):
    row = np.abs(np.asarray(d, np.float64)).copy()
    if len(e):
        row[:-1] += np.abs(e)
        row[1:] += np.abs(e)
    return float(row.max())


def _problem(n, seed=0):
    rng = np.random.default_rng(seed + n)
    return rng.normal(size=n), rng.normal(size=n - 1)


# ------------------------------------------------------------ the mesh


def test_make_solver_mesh_validates_and_describes():
    mesh = _mesh(4)
    assert mesh.shards == 4
    assert mesh.devices == (CPU,) * 4
    assert hash(mesh) == hash(_mesh(4)) and mesh == _mesh(4)
    assert describe(mesh) == "shard=4 on cpu, cpu, cpu, cpu"
    assert make_solver_mesh(2, devices=[CPU] * 4).devices == (CPU, CPU)
    with pytest.raises(ValueError, match="power of two"):
        make_solver_mesh(3, devices=[CPU] * 3)
    with pytest.raises(ValueError):
        make_solver_mesh(0, devices=[CPU])
    with pytest.raises(ValueError, match=r"devices=\["):
        make_solver_mesh(4, devices=[CPU] * 2)
    # No card here: the default device list is empty, and the message
    # names the spelling that runs several shards on one device.
    with pytest.raises(ValueError, match=r"devices=\['cuda:0'\] \* 2"):
        make_solver_mesh(2)


def test_collectives_move_values_between_shards():
    xs = [torch.full((2,), float(p + 1)) for p in range(4)]
    assert [x.tolist() for x in halo_from_left(xs)] == [
        [0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]
    lanes = gather_lanes([torch.tensor([[p, 10 + p]]) for p in range(3)])
    assert len(lanes) == 3 and lanes[0] is lanes[2]   # one device: shared
    assert lanes[0].tolist() == [[0, 10, 1, 11, 2, 12]]
    lam = [torch.arange(4.0) + 10 * p for p in range(2)]
    rows = [torch.arange(12.0).reshape(1, 3, 4) + 10 * p for p in range(2)]
    lam_g, rows_g = gather_tree_state([x[None] for x in lam], rows)
    assert lam_g[0].shape == (1, 2, 4) and rows_g[0].shape == (1, 2, 3, 4)
    assert torch.equal(lam_g[0][0, 1], lam[1])
    assert torch.equal(rows_g[0][:, 1], rows[1])


# ------------------------------------------------------ against repro


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_quantize_lanes_matches_repro_bit_for_bit(dtype):
    x = (np.random.default_rng(7).normal(size=(3, 2, 64)) * 10.0).astype(
        dtype)
    x[1, 0] = 0.0                     # an all-zero lane: the tiny floor
    q, scale = quantize_lanes(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_lanes(x)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(scale.numpy().view(np.int32),
                          np.asarray(jscale).view(np.int32))
    deq = dequantize_lanes(q, scale, torch.from_numpy(x).dtype)
    assert deq.dtype == torch.from_numpy(x).dtype   # f32 trees stay f32
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcomp.dequantize_lanes(jq, jscale, dtype)))
    # Rounding to the int8 grid: at most half a quantization step.
    assert float(((torch.from_numpy(x).double() - deq.double()).abs()
                  / scale.double()).max()) <= 0.5 + 1e-6


@pytest.mark.parametrize("quarters", [(0, 4), (1, 1), (3, 1)])
def test_window_solve_matches_repro_and_the_full_solve(quarters):
    """Roots [start, start + nroots) of B = 3 problems with kprime < K,
    against the JAX package's window solve at the kernel bar, and equal
    to the same columns of the port's full solve bit for bit (the
    dispatcher's plain path, as on a CPU tensor); the single-problem
    window solve likewise."""
    B, K, kprime = 3, 256, 201
    start, nroots = (q * K // 4 for q in quarters)
    rng = np.random.default_rng(11)
    d = np.sort(rng.standard_normal((B, K)), axis=1)
    d[:, kprime:] += 10.0
    z = rng.standard_normal((B, K))
    z[:, kprime:] = 0.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    rho = np.full((B,), 0.7)
    kp = np.full((B,), kprime, np.int32)
    t = torch.from_numpy
    o, tau = ops.secular_solve_window_batched(
        t(d), t(z * z), t(rho), t(kp), start, nroots, niter=16, chunk=64)
    assert o.shape == tau.shape == (B, nroots)
    jo, jt = jsec.secular_solve_window_batched(d, z * z, rho, kp, start,
                                               nroots, niter=16)
    lam = np.take_along_axis(d, o.numpy().astype(np.int64), 1) + tau.numpy()
    jlam = np.take_along_axis(d, np.asarray(jo).astype(np.int64), 1) \
        + np.asarray(jt)
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-13)
    fo, ft = tsec.secular_solve_batched(t(d), t(z * z), t(rho), t(kp),
                                        niter=16, chunk=128)
    assert torch.equal(o, fo[:, start:start + nroots])
    assert torch.equal(tau, ft[:, start:start + nroots])
    # The single-problem view: problem 1's row of the batched window, and
    # the JAX package's single-problem window solve at the kernel bar.
    so, st = tsec.secular_solve_window(t(d[1]), t(z[1] * z[1]), 0.7,
                                       kprime, start, nroots, niter=16)
    assert torch.equal(so, o[1]) and torch.equal(st, tau[1])
    jso, jst = jsec.secular_solve_window(
        jax.numpy.asarray(d[1]), jax.numpy.asarray(z[1] * z[1]), 0.7,
        kprime, start, nroots, niter=16)
    np.testing.assert_allclose(
        d[1][np.asarray(jso)] + np.asarray(jst), lam[1], rtol=0, atol=1e-13)


_REPRO_SHARDED = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from repro.core import eigvalsh_tridiagonal
assert jax.device_count() == 4, jax.device_count()
problems = np.load(sys.argv[1])
out = {}
for name in sorted({k.split("/")[0] for k in problems.files}):
    d, e = problems[name + "/d"], problems[name + "/e"]
    for P in (2, 4):
        out[f"{name}/{P}"] = np.asarray(
            eigvalsh_tridiagonal(d, e, leaf=8, mesh=P))
np.savez(sys.argv[2], **out)
"""


def test_sharded_matches_repro_sharded_and_single_device(tmp_path):
    """The JAX package's sharded solve of the five families at n = 257,
    leaf 8, P in {2, 4} (a subprocess with four forced host devices; the
    problems travel as numpy arrays, since a family's default seed hashes
    its name per process), against the port's sharded solve at the
    conformance bar; within the port, sharded == single-device bit for
    bit."""
    problems = {f: make_family(f, 257, seed=i)
                for i, f in enumerate(FAMILIES)}
    inp, out = tmp_path / "problems.npz", tmp_path / "repro_sharded.npz"
    np.savez(inp, **{f"{f}/{x}": a for f, (d, e) in problems.items()
                     for x, a in (("d", d), ("e", e))})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REPRO_SHARDED, str(inp), str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(out)
    for family, (d, e) in problems.items():
        bar = 64 * EPS * max(1.0, _tinf(d, e))
        single = eigvalsh_tridiagonal(d, e, leaf=8, mesh=1, device=CPU)
        for P in (2, 4):
            got = eigvalsh_tridiagonal(d, e, leaf=8, mesh=_mesh(P),
                                       device=CPU)
            assert torch.equal(got, single), (family, P)
            np.testing.assert_allclose(got.numpy(), want[f"{family}/{P}"],
                                       rtol=0, atol=bar,
                                       err_msg=f"{family} P={P}")


# ------------------------------------------------- sharded vs single


def test_sharded_boundary_rows_padded_batch():
    rng = np.random.default_rng(1)
    n = 700                                   # pads: the tracked third row
    d = rng.normal(size=(3, n))
    e = rng.normal(size=(3, n - 1))
    r1 = eigvalsh_tridiagonal_batch(d, e, return_boundary=True, mesh=1,
                                    device=CPU)
    r4 = eigvalsh_tridiagonal_batch(d, e, return_boundary=True,
                                    mesh=_mesh(4), device=CPU)
    assert torch.equal(r1.eigenvalues, r4.eigenvalues)
    assert torch.equal(r1.blo, r4.blo)
    assert torch.equal(r1.bhi, r4.bhi)
    assert len(r1.kprime_per_level) == len(r4.kprime_per_level)
    for a, b in zip(r1.kprime_per_level, r4.kprime_per_level):
        assert torch.equal(a, b)


def test_two_pass_sharded_equals_single_device():
    d, e = _problem(300, seed=2)
    lam1 = eigvalsh_tridiagonal(d, e, fused=False, mesh=1, device=CPU)
    lam4 = eigvalsh_tridiagonal(d, e, fused=False, mesh=_mesh(4), device=CPU)
    assert torch.equal(lam1, lam4)


def test_compress_halo_off_is_bit_identical_and_on_is_lossy():
    d, e = _problem(700)
    lam1 = eigvalsh_tridiagonal(d, e, mesh=1, device=CPU)
    off = eigvalsh_tridiagonal(d, e, mesh=_mesh(4), compress_halo=False,
                               device=CPU)
    assert torch.equal(off, lam1)
    lossy = eigvalsh_tridiagonal(d, e, mesh=_mesh(4), compress_halo=True,
                                 device=CPU)
    norm = np.max(np.abs(d)) + 2.0 * np.max(np.abs(e))
    err = float((lossy - lam1).abs().max())
    assert 0.0 < err <= 0.05 * norm


# ------------------------------------------------- cache and serving


def test_no_new_plan_on_repeated_same_mesh_traffic():
    d, e = _problem(300, seed=5)
    eigvalsh_tridiagonal(d, e, mesh=_mesh(4), device=CPU)
    before = EXECUTOR_TRACES.count
    for shift in (0.5, -1.0, 2.0):
        eigvalsh_tridiagonal(d + shift, e, mesh=_mesh(4), device=CPU)
    assert EXECUTOR_TRACES.count == before


def test_mesh_buckets_in_plan_cache_stats():
    clear_plan_cache()
    p1 = tplan.make_plan(300, mesh=1, device=CPU)
    p2 = tplan.make_plan(300, mesh=_mesh(2), device=CPU)
    p4 = tplan.make_plan(300, mesh=_mesh(4), device=CPU)
    assert (p1.devices, p2.devices, p4.devices) == (1, 2, 4)
    assert p1.key.mesh_devices == ()
    assert p4.key.mesh_devices == (CPU,) * 4
    assert plan_cache_stats()["mesh_buckets"] == {1: 1, 2: 1, 4: 1}


def test_serve_flush_lands_on_sharded_route():
    from repro_torch.serve import EigensolverClient
    probs = [_problem(n, seed=3) for n in (257, 300, 420)]
    with EigensolverClient(max_batch=8, max_wait_us=100_000) as client:
        futs = [client.solve_async(d, e, mesh=_mesh(2), device=CPU)
                for d, e in probs]
        results = [f.result(timeout=300) for f in futs]
        stats = client.metrics()
    for (d, e), res in zip(probs, results):
        want = eigvalsh_tridiagonal(d, e, mesh=_mesh(2), device=CPU)
        assert torch.equal(res.eigenvalues, want)
    assert stats["plan_cache"]["mesh_buckets"].get(2, 0) >= 1
    assert sum(b["errors"] + b["fallbacks"] + b["retries"]
               for b in stats["buckets"].values()) == 0


# ---------------------------------------------------------- routing


@pytest.mark.parametrize("mesh,match", [
    (3, "power of two"),
    (make_solver_mesh(4, devices=[CPU] * 4), "leaves"),
    (2, "devices"),
    ("typo", "mesh"),
])
def test_explicit_mesh_validates_hard(mesh, match):
    """A non-power-of-two count, a mesh with more shards than the tree has
    leaves (N = 64 with leaf 32), a count past the visible devices (one
    CPU), a typo'd string."""
    n = 64 if match == "leaves" else 16384
    with pytest.raises(ValueError, match=match):
        tplan.resolve_solve_route(n, leaf=32, mesh=mesh, device=CPU)


def test_auto_routing_and_compress_halo_normalized_off_at_one_shard():
    for mesh in ("auto", None, 1):
        assert tplan.resolve_solve_route(16384, mesh=mesh,
                                         device=CPU).shards == 1
    route = tplan.resolve_solve_route(1024, mesh=1, compress_halo=True,
                                      device=CPU)
    assert route.shards == 1 and route.compress_halo is False
    assert route == tplan.resolve_solve_route(1024, mesh=1, device=CPU)
    sharded = tplan.resolve_solve_route(1024, mesh=_mesh(2),
                                        compress_halo=True, device=CPU)
    assert (sharded.shards, sharded.compress_halo) == (2, True)
