"""The port's package boundary and kernel dispatch.

  * ``import repro_torch`` loads neither ``jax`` nor ``repro``, and the
    kernel modules import on a machine without ``nvcc``;
  * entry points run on the card by default and raise without one unless
    the caller passes ``device="cpu"``;
  * dispatch goes by the tensor's device: CPU tensors take the plain
    versions, anything else that is not CUDA raises;
  * on a card (``gpu`` marker, run with ``python -m pytest -m gpu
    --noconftest``: the machine with the card has no JAX), each
    kernel against its plain version at the tolerances of
    tests/test_kernels.py, f32 scaled by eps; the Sturm-count kernels
    bit for bit (counts and derivative sums); the QL kernel at
    64 eps * max(1, ||T||_inf), the conformance bar (hypot differs
    between math libraries by an ulp, which moves QL's trajectory by
    about the algorithm's own error); the root solve and the resident
    merge also batched == looped, and equal bit for bit whatever launch
    shape (cluster and CTA size) a batch gives them; the deflation chain
    equal to the plain chain run on the card bit for bit, once per level
    and with no host sync; and a batched solve equal to the looped one bit
    for bit, with the first batch-dependent tensor named if not.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (eigvalsh_tridiagonal,  # noqa: E402
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_range, make_family,
                              make_family_batch)
from repro_torch.core import br_dc as tbr  # noqa: E402
from repro_torch.core import merge as tmerge  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.core import sterf as tsterf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.boundary_update import (  # noqa: E402
    boundary_rows_update_cuda)
from repro_torch.kernels import deflate_chain as dck  # noqa: E402
from repro_torch.kernels.deflate_chain import deflate_chain_cuda  # noqa: E402
from repro_torch.kernels.fused_update import secular_postpass_cuda  # noqa: E402
from repro_torch.kernels import resident_merge as rmod  # noqa: E402
from repro_torch.kernels.resident_merge import resident_merge_cuda  # noqa: E402
from repro_torch.kernels.secular_roots import secular_solve_cuda  # noqa: E402
from repro_torch.kernels import sterf as qlk  # noqa: E402
from repro_torch.kernels.sterf import sterf_cuda  # noqa: E402
from repro_torch.kernels.zhat import zhat_reconstruct_cuda  # noqa: E402
from repro_torch.kernels.sturm_count import (  # noqa: E402
    chain_probe_cuda, launch_shape, sturm_bisect_tree_cuda, sturm_count_cuda,
    sturm_count_newton_cuda)
from repro_torch.core import bisect as tbis  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def test_import_loads_neither_jax_nor_repro_and_needs_no_nvcc():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.core.bisect, repro_torch.runtime.faults\n"
        "import repro_torch.kernels.sturm_count, repro_torch.kernels.zhat\n"
        "import repro_torch.kernels.boundary_update\n"
        "import repro_torch.kernels.sterf, repro_torch.core.baselines\n"
        "import repro_torch.kernels.deflate_chain\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=SRC, PATH="/usr/bin:/bin",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_a_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, e = make_family("uniform", 40, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigvalsh_tridiagonal(d, e)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eigvalsh_tridiagonal(d, e, device="cuda")
    assert eigvalsh_tridiagonal(d, e, device="cpu").shape == (40,)


def _problem(B, K, kprime, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((B, K)), axis=1)
    d[:, kprime:] += 10.0
    z = rng.standard_normal((B, K))
    z[:, kprime:] = 0.0
    nrm = np.linalg.norm(z, axis=1, keepdims=True)
    z /= np.where(nrm > 0, nrm, 1.0)           # kprime = 0: z stays zero
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (t(d), t(z), torch.full((B,), 0.7, dtype=dtype, device=device),
            torch.full((B,), kprime, dtype=torch.int32, device=device))


def test_cpu_tensors_take_the_plain_versions():
    d, z, rho, kp = _problem(2, 40, 33, seed=1)
    R = torch.randn(2, 3, 40, dtype=torch.float64)
    before = (secular_solve_cuda.launches, secular_postpass_cuda.launches,
              resident_merge_cuda.launches)
    o, t = ops.secular_solve_batched(d, z * z, rho, kp)
    o2, t2 = tsec.secular_solve_batched(d, z * z, rho, kp, niter=16,
                                        chunk=256)
    assert torch.equal(o, o2) and torch.equal(t, t2)
    ops.secular_postpass_batched(R, d, z, o, t, kp, rho)
    ops.secular_merge_resident_batched(d, z, R, rho, kp)
    assert before == (secular_solve_cuda.launches,
                      secular_postpass_cuda.launches,
                      resident_merge_cuda.launches)


def test_other_devices_and_cpu_tensors_never_reach_a_kernel_quietly():
    d, z, rho, kp = _problem(1, 8, 8, seed=2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ops.secular_solve_batched(d.to("meta"), (z * z).to("meta"),
                                  rho.to("meta"), kp.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        secular_solve_cuda(d, z * z, rho, kp, niter=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resident_merge_cuda(d, z, torch.zeros(1, 2, 8, dtype=d.dtype), rho,
                            kp, niter=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tols(dtype):
    scale = (np.finfo(np.float32).eps / np.finfo(np.float64).eps
             if dtype == torch.float32 else 1.0)
    return 1e-13 * scale, 1e-12 * scale, 1e-10 * scale


def _assert_wrong_weights_fail(w, want, atol, rtol):
    """A zeroed and a sign-flipped weight vector fail the bar that ``w``
    passes (the bar tells a right weight from a wrong one wherever a
    weight is above atol; the caller's inputs have such weights)."""
    bar = atol + rtol * want.abs()
    assert bool(((w - want).abs() <= bar).all())
    assert bool((want.abs() > atol).any())
    for wrong in (torch.zeros_like(w), -w):
        assert not bool(((wrong - want).abs() <= bar).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,K,kprime", [(3, 130, 101), (2, 1030, 700),
                                        (1, 16, 1), (1, 8192, 7165)])
def test_kernels_match_plain_on_card(cuda_device, dtype, B, K, kprime):
    """The root solve, the fused post-pass and (where its lane fits in
    shared memory) the resident merge against their plain versions; a
    K = 8192 lane with a kprime that is not a multiple of the team size
    takes the post-pass at the size of the main path's top levels."""
    d, z, rho, kp = _problem(B, K, kprime, seed=3, dtype=dtype,
                             device=cuda_device)
    R = torch.randn(B, 3, K, dtype=dtype, device=cuda_device)
    niter = ops.resolve_niter(None, dtype)
    lam_tol, atol, rtol = _tols(dtype)
    o1, t1 = secular_solve_cuda(d, z * z, rho, kp, niter=niter)
    o2, t2 = tsec.secular_solve_batched(d, z * z, rho, kp, niter=niter)
    torch.testing.assert_close(tsec.secular_eigenvalues(d, o1, t1),
                               tsec.secular_eigenvalues(d, o2, t2),
                               atol=lam_tol, rtol=0)
    zh1, r1 = secular_postpass_cuda(R, d, z, o2, t2, kp, rho)
    zh2, r2 = tsec.secular_postpass_batched(R, d, z, o2, t2, kp, rho)
    torch.testing.assert_close(zh1, zh2, atol=atol, rtol=rtol)
    torch.testing.assert_close(r1, r2, atol=atol, rtol=rtol)
    _assert_wrong_weights_fail(zh1, zh2, atol, rtol)
    if rmod.smem_bytes(3, K, dtype) > rmod.SMEM_LIMIT:
        return
    res1 = resident_merge_cuda(d, z, R, rho, kp, niter=niter)
    res2 = tsec.secular_merge_resident_batched(d, z, R, rho, kp, niter=niter)
    torch.testing.assert_close(tsec.secular_eigenvalues(d, *res1[:2]),
                               tsec.secular_eigenvalues(d, *res2[:2]),
                               atol=lam_tol, rtol=0)
    for a, b in zip(res1[2:], res2[2:]):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_batched_kernel_equals_looped_kernel_bitwise(cuda_device):
    d, z, rho, kp = _problem(4, 300, 250, seed=4, device=cuda_device)
    R = torch.randn(4, 2, 300, dtype=d.dtype, device=cuda_device)
    o, t = secular_solve_cuda(d, z * z, rho, kp, niter=16)
    zh, rows = secular_postpass_cuda(R, d, z, o, t, kp, rho)
    for b in range(4):
        s = slice(b, b + 1)
        ob, tb = secular_solve_cuda(d[s], (z * z)[s], rho[s], kp[s],
                                    niter=16)
        assert torch.equal(ob[0], o[b]) and torch.equal(tb[0], t[b])
        zb, rb = secular_postpass_cuda(R[s], d[s], z[s], o[s], t[s], kp[s],
                                       rho[s])
        assert torch.equal(zb[0], zh[b]) and torch.equal(rb[0], rows[b])


@pytest.mark.gpu
def test_resident_batched_equals_looped_bitwise(cuda_device):
    # Lanes of three kprimes in one launch.
    parts = [_problem(B, 300, kprime, seed=14 + kprime, device=cuda_device)
             for B, kprime in ((2, 250), (1, 300), (1, 7))]
    d, z, rho, kp = (torch.cat(t) for t in zip(*parts))
    R = torch.randn(4, 3, 300, dtype=d.dtype, device=cuda_device)
    res = resident_merge_cuda(d, z, R, rho, kp, niter=16)
    for b in range(4):
        s = slice(b, b + 1)
        one = resident_merge_cuda(d[s], z[s], R[s], rho[s], kp[s], niter=16)
        for a, c in zip(one, res):
            assert torch.equal(a[0], c[b])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,kprime,B", [(64, 48, 600), (2048, 1536, 200)])
def test_kernels_bitwise_across_launch_shapes(cuda_device, dtype, K, kprime,
                                              B):
    """The same lanes launched alone (B = 1) and inside a batch of B, where
    the resident merge's cluster size differs (at K = 64 a lane is split
    in two up to 528 lanes, so the batch takes 600): both kernels give the
    same bits (a root's sums run in an order set by the team size and the
    index alone)."""
    from repro_torch.kernels.resident_merge import launch_shape, sm_count
    d, z, rho, kp = _problem(B, K, kprime, seed=K + 15, dtype=dtype,
                             device=cuda_device)
    R = torch.randn(B, 3, K, dtype=dtype, device=cuda_device)
    sms = sm_count(d.device.index)
    assert (launch_shape(1, K, 3, dtype, sms)
            != launch_shape(B, K, 3, dtype, sms))
    niter = ops.resolve_niter(None, dtype)
    o, t = secular_solve_cuda(d, z * z, rho, kp, niter=niter)
    res = resident_merge_cuda(d, z, R, rho, kp, niter=niter)
    for b in (0, 77, B - 1):
        s = slice(b, b + 1)
        ob, tb = secular_solve_cuda(d[s], (z * z)[s], rho[s], kp[s],
                                    niter=niter)
        assert torch.equal(ob[0], o[b]) and torch.equal(tb[0], t[b])
        one = resident_merge_cuda(d[s], z[s], R[s], rho[s], kp[s],
                                  niter=niter)
        for a, c in zip(one, res):
            assert torch.equal(a[0], c[b])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K", [64, 2048])
@pytest.mark.parametrize("edge", ["1", "K-1", "K"])
def test_roots_and_resident_at_kprime_edges_match_plain(cuda_device, dtype,
                                                        K, edge):
    """kprime of 1 (the closed form), K - 1 and K (no deflated root), at
    the smallest and the largest resident merge size."""
    kprime = {"1": 1, "K-1": K - 1, "K": K}[edge]
    d, z, rho, kp = _problem(2, K, kprime, seed=K + kprime, dtype=dtype,
                             device=cuda_device)
    R = torch.randn(2, 3, K, dtype=dtype, device=cuda_device)
    niter = ops.resolve_niter(None, dtype)
    lam_tol, atol, rtol = _tols(dtype)
    o1, t1 = secular_solve_cuda(d, z * z, rho, kp, niter=niter)
    o2, t2 = tsec.secular_solve_batched(d, z * z, rho, kp, niter=niter)
    torch.testing.assert_close(tsec.secular_eigenvalues(d, o1, t1),
                               tsec.secular_eigenvalues(d, o2, t2),
                               atol=lam_tol, rtol=0)
    res1 = resident_merge_cuda(d, z, R, rho, kp, niter=niter)
    res2 = tsec.secular_merge_resident_batched(d, z, R, rho, kp, niter=niter)
    torch.testing.assert_close(tsec.secular_eigenvalues(d, *res1[:2]),
                               tsec.secular_eigenvalues(d, *res2[:2]),
                               atol=lam_tol, rtol=0)
    for a, b in zip(res1[2:], res2[2:]):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


def _sturm_problem(B, n, S, seed, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((B, n))
    e = rng.uniform(0.05, 0.5, (B, max(n - 1, 0)))
    shifts = rng.uniform(-3, 3, (B, S))
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    e2 = t(e * e)
    return t(d), e2, t(shifts), tbis._pivot_floor(e2)


def test_cpu_tensors_take_the_plain_sturm_versions():
    d, e2, x, piv = _sturm_problem(2, 30, 7, seed=5)
    before = (sturm_count_cuda.launches, sturm_count_newton_cuda.launches)
    assert torch.equal(ops.sturm_count_batched(d, e2, x, piv),
                       tbis.sturm_count_plain(d, e2, x, piv))
    c, s = ops.count_and_newton_batched(d, e2, x, piv)
    c2, s2 = tbis._count_and_newton(d, e2, x, piv)
    assert torch.equal(c, c2) and torch.equal(s, s2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sturm_count_cuda(d, e2, x, piv[:, 0])
    assert before == (sturm_count_cuda.launches,
                      sturm_count_newton_cuda.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,S", [(1, 8, 4), (4, 300, 130), (3, 1, 5),
                                   (2, 257, 1), (8, 33, 64), (1, 1030, 65)])
def test_sturm_kernels_match_plain_on_card(cuda_device, dtype, B, n, S):
    """Counts are integers and every operation is rounded on its own, so
    both kernels equal their plain versions bit for bit."""
    d, e2, x, piv = _sturm_problem(B, n, S, seed=B * 1000 + n, dtype=dtype,
                                   device=cuda_device)
    x[:, -1] = x[:, 0]                      # a duplicate shift
    cnt = sturm_count_cuda(d, e2, x, piv[:, 0])
    assert torch.equal(cnt.cpu(), tbis.sturm_count_plain(
        d.cpu(), e2.cpu(), x.cpu(), piv.cpu()))
    c2, s2 = sturm_count_newton_cuda(d, e2, x, piv[:, 0])
    c3, s3 = tbis._count_and_newton(d.cpu(), e2.cpu(), x.cpu(), piv.cpu())
    assert torch.equal(c2.cpu(), c3) and torch.equal(c2, cnt)
    assert torch.equal(s2.cpu(), s3)


@pytest.mark.gpu
def test_sturm_kernel_on_eigenvalues_and_zero_couplings(cuda_device):
    d0, e0 = make_family("normal", 96, seed=3)
    lam = np.linalg.eigvalsh(np.diag(d0) + np.diag(e0, 1) + np.diag(e0, -1))
    d = torch.tensor(np.stack([d0, d0]), device=cuda_device)
    e2 = torch.tensor(np.stack([e0 * e0, np.zeros(95)]), device=cuda_device)
    x = torch.tensor(np.stack([lam, np.sort(d0)]), device=cuda_device)
    piv = tbis._pivot_floor(e2)
    cnt = sturm_count_cuda(d, e2, x, piv[:, 0])
    assert torch.equal(cnt.cpu(), tbis.sturm_count_plain(
        d.cpu(), e2.cpu(), x.cpu(), piv.cpu()))
    np.testing.assert_array_equal(cnt[1].cpu().numpy(), np.arange(1, 97))


@pytest.mark.gpu
def test_sturm_kernel_shift_block_invariance(cuda_device):
    """How the shifts split into blocks is a tiling matter, never a
    semantics one: launching column slices of every width gives the
    counts of one launch."""
    d, e2, x, piv = _sturm_problem(2, 100, 200, seed=11, device=cuda_device)
    whole = sturm_count_cuda(d, e2, x, piv[:, 0])
    for w in (1, 17, 64, 100):
        parts = [sturm_count_cuda(d, e2, x[:, s:s + w].contiguous(),
                                  piv[:, 0]) for s in range(0, 200, w)]
        assert torch.equal(torch.cat(parts, dim=1), whole)


@pytest.mark.gpu
def test_sturm_batched_equals_looped_bitwise(cuda_device):
    d, e2, x, piv = _sturm_problem(5, 700, 90, seed=12, device=cuda_device)
    cnt, s = sturm_count_newton_cuda(d, e2, x, piv[:, 0])
    for b in range(5):
        sl = slice(b, b + 1)
        cb, sb = sturm_count_newton_cuda(d[sl], e2[sl], x[sl], piv[sl, 0])
        assert torch.equal(cb[0], cnt[b]) and torch.equal(sb[0], s[b])
        assert torch.equal(sturm_count_cuda(d[sl], e2[sl], x[sl],
                                            piv[sl, 0])[0], cnt[b])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 1000])
def test_chain_probe_walks_the_count_kernels_recurrence(cuda_device, n):
    """The one-thread chain probe (the trip's latency bound) computes the
    same count as the count kernel, over every remainder of its unrolled
    row groups, and reports a positive cycle count."""
    d, e2, x, piv = _sturm_problem(1, n, 9, seed=13 + n, device=cuda_device)
    cnt = sturm_count_cuda(d, e2, x, piv[:, 0])
    for j in range(9):
        c, cycles = chain_probe_cuda(d[0], e2[0].contiguous(),
                                     float(x[0, j]), float(piv[0, 0]))
        assert int(c) == int(cnt[0, j]) and int(cycles) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,S,split", [
    (3, 1030, 130, True), (2, 2500, 97, True), (1, 9, 1, True),
    (40, 1100, 700, False), (128, 200, 1100, False)])
def test_sweep_layouts_match_plain_on_card(cuda_device, dtype, B, n, S,
                                           split):
    """The count and the Newton sweep in both of its layouts -- two
    threads a shift and one, which the wrapper picks from these shapes on
    either side of its crossover -- at ragged S, n across several row
    tiles: counts and derivative sums equal the plain versions bit for
    bit.  In float32 a pivot at the floor sends r = q'/q past the range
    and the sum to NaN (one lane here, on both sides): the NaNs must sit
    in the same lanes, whatever their payloads."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert launch_shape(B, S, sms, newton=True)[0] == split
    d, e2, x, piv = _sturm_problem(B, n, S, seed=B + n + S, dtype=dtype,
                                   device=cuda_device)
    x[:, -1] = x[:, 0]
    cnt = sturm_count_cuda(d, e2, x, piv[:, 0])
    assert torch.equal(cnt.cpu(), tbis.sturm_count_plain(
        d.cpu(), e2.cpu(), x.cpu(), piv.cpu()))
    c2, s2 = sturm_count_newton_cuda(d, e2, x, piv[:, 0])
    c3, s3 = tbis._count_and_newton(d.cpu(), e2.cpu(), x.cpu(), piv.cpu())
    assert torch.equal(c2.cpu(), c3)
    torch.testing.assert_close(s2.cpu(), s3, rtol=0, atol=0, equal_nan=True)


def _tree_start(B, n, k, seed, dtype, device):
    """Brackets as ``_slice_targets`` starts them, for random targets."""
    d, e2, _, piv = _sturm_problem(B, n, 1, seed=seed, dtype=dtype,
                                   device=device)
    glo, ghi = tbis._gershgorin(d, e2.sqrt(), piv)
    scale = torch.maximum(glo.abs(), ghi.abs())
    tol = 2.0 * torch.finfo(dtype).eps * scale + 2.0 * piv
    rng = np.random.default_rng(seed)
    targets = torch.tensor(np.sort(rng.integers(0, n, (B, k)), axis=1),
                           dtype=torch.int32, device=device)
    return (d, e2, piv, tol, targets, glo.expand(B, k).contiguous(),
            ghi.expand(B, k).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,n,k,depth,steps", [
    (2, 1030, 37, 3, 3), (1, 2500, 5, 8, 8), (3, 1, 3, 2, 1),
    (2, 300, 70, 5, 4), (1, 4097, 3, 1, 1), (2, 65, 9, 7, 7)])
def test_bisect_tree_kernel_matches_plain_on_card(cuda_device, dtype, B, n,
                                                  k, depth, steps):
    """n not a multiple of the row tile and k not a multiple of a block's
    brackets: lo, hi and every node count equal the plain tree's bit for
    bit, launch after launch (brackets converge and freeze on the way:
    9 launches of ``steps`` halvings)."""
    state = _tree_start(B, n, k, seed=n + k, dtype=dtype,
                        device=cuda_device)
    d, e2, piv, tol, targets, lo, hi = state
    cpu = [t.cpu() for t in state]
    for _ in range(9):
        lo, hi, counts = sturm_bisect_tree_cuda(
            d, e2, piv[:, 0], tol[:, 0], targets, lo, hi, depth=depth,
            steps=steps)
        lo_p, hi_p, counts_p = tbis.bisect_tree_plain(
            *cpu[:5], cpu[5], cpu[6], depth=depth, steps=steps)
        assert torch.equal(counts.cpu(), counts_p)
        assert torch.equal(lo.cpu(), lo_p) and torch.equal(hi.cpu(), hi_p)
        cpu[5], cpu[6] = lo_p, hi_p


@pytest.mark.gpu
def test_range_solve_launches_at_most_seven_trees_and_two_sweeps(
        cuda_device):
    """The n = 16384 bottom-64 range solve: the tree takes 8 halvings a
    launch (64 brackets), so bisection needs at most 7 launches, and the
    Newton polish its 2 sweeps; no single-halving count sweep runs."""
    d, e = make_family("uniform", 16384, seed=0)
    eigvalsh_tridiagonal(d[:64], e[:63], method="bisect")   # warm build
    kernels = (sturm_bisect_tree_cuda, sturm_count_newton_cuda,
               sturm_count_cuda)
    before = [k.launches for k in kernels]
    lam = eigvalsh_tridiagonal_range(d, e, il=0, iu=63)
    tree, newton, count = (k.launches - b for k, b in zip(kernels, before))
    assert lam.shape == (64,) and bool(torch.isfinite(lam).all())
    assert 1 <= tree <= 7 and newton == 2 and count == 0


def test_cpu_tensors_take_the_plain_two_pass_and_ql_versions():
    d, z, rho, kp = _problem(2, 40, 33, seed=6)
    R = torch.randn(2, 40, 40, dtype=torch.float64)
    o, t = ops.secular_solve_batched(d, z * z, rho, kp)
    before = (zhat_reconstruct_cuda.launches,
              boundary_rows_update_cuda.launches, sterf_cuda.launches)
    w = ops.zhat_reconstruct_batched(d, z, o, t, kp, rho)
    assert torch.equal(w, tsec.zhat_reconstruct_batched(d, z, o, t, kp, rho))
    assert torch.equal(
        ops.boundary_rows_update_batched(R, d, w, o, t, kp),
        tsec.boundary_rows_update_batched(R, d, w, o, t, kp))
    dd, ee = make_family("uniform", 30, seed=6)
    lam, steps = ops.sterf_batched(torch.tensor(dd)[None],
                                   torch.tensor(ee)[None])
    lam2, steps2 = tsterf.sterf_plain(torch.tensor(dd)[None],
                                      torch.tensor(ee)[None])
    assert torch.equal(lam, lam2) and torch.equal(steps, steps2)
    for launch in (lambda: zhat_reconstruct_cuda(d, z, o, t, kp, rho),
                   lambda: boundary_rows_update_cuda(R, d, w, o, t, kp),
                   lambda: sterf_cuda(torch.tensor(dd)[None],
                                      torch.tensor(ee)[None])):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
    assert before == (zhat_reconstruct_cuda.launches,
                      boundary_rows_update_cuda.launches,
                      sterf_cuda.launches)


def _rows_bar(R, want, dtype):
    """The row update's bar against its plain version, per entry: atol +
    rtol |plain| for r <= 4 rows; for r > 4 an entry is a K-term dot
    product of a row of R with a unit column of Y, held to atol +
    2 sqrt(K) eps ||R[b, i, :]||."""
    _, atol, rtol = _tols(dtype)
    r, K = R.shape[1:]
    if r <= 4:
        return atol + rtol * want.abs()
    return atol + (2 * math.sqrt(K) * float(torch.finfo(dtype).eps)
                   * R.norm(dim=2, keepdim=True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,K,kprime", [(3, 130, 101), (2, 1030, 700),
                                        (1, 16, 1), (2, 257, 256),
                                        (2, 130, 0), (2, 300, 300),
                                        (1, 8192, 7165)])
def test_two_pass_kernels_match_plain_on_card(cuda_device, dtype, B, K,
                                              kprime):
    """zhat and the row update against their plain versions, with an exact
    zero denominator planted in root column 0 (the plain version's rule:
    the pole contributes its weight); kprime from 0 (every column passes
    R through) to K, a K = 8192 lane whose kprime is not a multiple of
    the team size, and r in {1, 3, 4, 5, 64, 65, 129, K}: both paths of
    the row update (a team per column up to 4 rows, output tiles above:
    on the FP64 tensor cores in float64) with ragged row tiles.  A zeroed
    and a sign-flipped output must fail the row update's bar, and a
    zeroed and a sign-flipped zhat the weights' bar."""
    for r in (1, 3, 4, 5, 64, 65, 129, K):
        d, z, rho, kp = _problem(B, K, kprime, seed=K + r, dtype=dtype,
                                 device=cuda_device)
        R = torch.randn(B, r, K, dtype=dtype, device=cuda_device)
        niter = ops.resolve_niter(None, dtype)
        o, t = tsec.secular_solve_batched(d, z * z, rho, kp, niter=niter)
        o[:, 0], t[:, 0] = 0, 0.0             # delta_00 == 0 exactly
        _, atol, rtol = _tols(dtype)
        w = zhat_reconstruct_cuda(d, z, o, t, kp, rho)
        w_plain = tsec.zhat_reconstruct_batched(d, z, o, t, kp, rho)
        torch.testing.assert_close(
            w, w_plain, atol=atol, rtol=rtol, msg=lambda m: f"r={r}: {m}")
        if kprime > 1:      # kprime = 1: the planted root leaves zhat_0 tiny
            _assert_wrong_weights_fail(w, w_plain, atol, rtol)
        rows = boundary_rows_update_cuda(R, d, w, o, t, kp)
        want = tsec.boundary_rows_update_batched(R, d, w, o, t, kp)
        bar = _rows_bar(R, want, dtype)
        err = (rows - want).abs()
        assert bool(torch.isfinite(rows).all()), f"r={r}"
        assert bool((err <= bar).all()), (
            f"r={r}: max |kernel - plain| {float(err.max()):.3e}, "
            f"worst excess {float((err - bar).max()):.3e}")
        for wrong in (torch.zeros_like(rows), -rows):
            assert not bool(((wrong - want).abs() <= bar).all()), f"r={r}"


@pytest.mark.gpu
@pytest.mark.parametrize("r", [2, 70])
def test_two_pass_batched_equals_looped_bitwise(cuda_device, r):
    """A batch of 200 lanes against each lane launched alone (B = 1), bit
    for bit, on both paths of the row update (r = 2: a team per column;
    r = 70: tiles on the FP64 tensor cores)."""
    B = 200
    d, z, rho, kp = _problem(B, 300, 250, seed=r, device=cuda_device)
    R = torch.randn(B, r, 300, dtype=d.dtype, device=cuda_device)
    o, t = secular_solve_cuda(d, z * z, rho, kp, niter=16)
    w = zhat_reconstruct_cuda(d, z, o, t, kp, rho)
    rows = boundary_rows_update_cuda(R, d, w, o, t, kp)
    for b in range(B):
        s = slice(b, b + 1)
        wb = zhat_reconstruct_cuda(d[s], z[s], o[s], t[s], kp[s], rho[s])
        rb = boundary_rows_update_cuda(R[s], d[s], w[s], o[s], t[s], kp[s])
        assert torch.equal(wb[0], w[b]) and torch.equal(rb[0], rows[b])


@pytest.mark.gpu
def test_f32_weights_stay_finite_where_poles_coincide_on_card(cuda_device):
    """Lanes 14 and 21 of the seed-2050 problem hold two poles that are
    one float32 value: the resident and fused kernels' weights stay
    finite and match their plain versions (ROADMAP Queue 3 item 2)."""
    rng = np.random.default_rng(2050)
    d = np.sort(rng.standard_normal((64, 2048)), axis=1)[[14, 21]]
    d[:, 1536:] += 10.0
    z = rng.standard_normal((64, 2048))[[14, 21]]
    z[:, 1536:] = 0.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                               device=cuda_device)
    d, z = t(d), t(z)
    rho = torch.full((2,), 0.7, dtype=torch.float32, device=cuda_device)
    kp = torch.full((2,), 1536, dtype=torch.int32, device=cuda_device)
    R = torch.randn(2, 2, 2048, dtype=torch.float32, device=cuda_device)
    _, atol, rtol = _tols(torch.float32)
    res = resident_merge_cuda(d, z, R, rho, kp, niter=10)
    o, tau = res[0], res[1]
    zh, rows = secular_postpass_cuda(R, d, z, o, tau, kp, rho)
    zp, rp = tsec.secular_postpass_batched(R, d, z, o, tau, kp, rho)
    for got in (res[2], res[3], zh, rows):
        assert bool(torch.isfinite(got).all())
    for a, b in ((res[2], zp), (zh, zp), (res[3], rp), (rows, rp)):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_weights_where_poles_coincide_far_from_the_next_root_on_card(
        cuda_device, dtype):
    """Two poles of one value with the next root 6.87 away (the CPU case
    of tests/test_torch_baselines.py): the resident and fused kernels'
    weights and rows are finite and match their plain versions."""
    d = np.array([[-40.0, -20.0, 0.0, 0.0, 30.0, 60.0, 90.0, 120.0]])
    z = np.random.default_rng(5).standard_normal((1, 8))
    d = torch.tensor(d, dtype=dtype, device=cuda_device)
    z = torch.tensor(z / np.linalg.norm(z), dtype=dtype, device=cuda_device)
    rho = torch.full((1,), 100.0, dtype=dtype, device=cuda_device)
    kp = torch.full((1,), 8, dtype=torch.int32, device=cuda_device)
    R = torch.eye(8, dtype=dtype, device=cuda_device)[None, :2]
    _, atol, rtol = _tols(dtype)
    res = resident_merge_cuda(d, z, R, rho, kp, niter=16)
    o, tau = res[0], res[1]
    zh, rows = secular_postpass_cuda(R, d, z, o, tau, kp, rho)
    zp, rp = tsec.secular_postpass_batched(R, d, z, o, tau, kp, rho)
    for got in (res[2], res[3], zh, rows):
        assert bool(torch.isfinite(got).all())
    for a, b in ((res[2], zp), (zh, zp), (res[3], rp), (rows, rp)):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_weights_where_pole_gaps_pass_the_reciprocal_range_on_card(
        cuda_device):
    """A float64 lane whose poles span 1.2 * 2^1023: the reciprocal of its
    widest gaps is subnormal, which the hardware estimate flushes to
    zero.  The weight kernel (zhat, and the post-pass's pass A) scales the
    lane's gaps into range (secular::gap_scale): its weights match the
    plain log-space ones, a zeroed or sign-flipped weight fails that bar,
    and they equal bit for bit the weights of the same lane scaled by
    2^-1000 (gaps in range, scale 1), since power-of-two scaling leaves
    every factor's bits."""
    K = 8
    d = np.linspace(-0.6, 0.6, K) * 2.0 ** 1023
    gap = np.diff(d)
    tau = 0.3 * np.append(gap, gap[-1])
    z = np.random.default_rng(11).standard_normal(K)
    z /= np.linalg.norm(z)
    lanes = np.array([1.0, 2.0 ** -1000])[:, None]
    t = lambda a, dt=torch.float64: torch.tensor(  # noqa: E731
        a, dtype=dt, device=cuda_device)
    d_b, tau_b, z_b = t(d * lanes), t(tau * lanes), t(np.tile(z, (2, 1)))
    origin = t(np.tile(np.arange(K), (2, 1)), torch.int32)
    rho = t(2.0 ** 1020 * lanes[:, 0])
    kp = torch.full((2,), K, dtype=torch.int32, device=cuda_device)
    R = t(np.tile(np.eye(K)[:2], (2, 1, 1)))
    _, atol, rtol = _tols(torch.float64)
    want = tsec.zhat_reconstruct_batched(d_b, z_b, origin, tau_b, kp, rho)
    w = zhat_reconstruct_cuda(d_b, z_b, origin, tau_b, kp, rho)
    wf, _ = secular_postpass_cuda(R, d_b, z_b, origin, tau_b, kp, rho)
    assert torch.equal(w, wf)
    assert torch.equal(w[0], w[1])
    _assert_wrong_weights_fail(w, want, atol, rtol)


def _sterf_bar(d, e, dtype):
    T = np.abs(d).max() + 2 * (np.abs(e).max() if len(e) else 0.0)
    return 64 * float(torch.finfo(dtype).eps) * max(1.0, T)


# Scales that push f^2 + g^2 out of the reciprocal square root's range,
# so the rotations take the guarded hypot branch.
_QL_SCALE = {"big": {torch.float64: 1e150, torch.float32: 1e20},
             "small": {torch.float64: 1e-150, torch.float32: 1e-20}}


def _sterf_in_rows(d, e, rows):
    """sterf_cuda with at most ``rows`` rows of (d, e) held in shared
    memory (0: device memory throughout; None: launch_shape's), so that a
    small problem runs a large one's regimes."""
    lam, _, steps = qlk._launch(d, e, 30 * d.shape[1], rows)
    return torch.sort(lam, dim=1).values, steps


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family,n", [("uniform", 2), ("uniform", 100),
                                      ("toeplitz", 64), ("clustered", 256),
                                      ("glued_wilkinson", 200),
                                      ("wilkinson", 21)])
def test_sterf_kernel_matches_plain_on_card(cuda_device, dtype, family, n):
    """The QL kernel against its plain loop with (d, e) in shared memory
    (the whole problem fits), in device memory (rows 0) and moving into
    shared memory once the active rows fit (rows n / 2): the regimes on
    both sides of the shared-memory limit, forced at a small n; and on
    inputs scaled by 1e+-150 (float32: 1e+-20), where the rotations take
    the guarded hypot branch."""
    d, e = make_family(family, n, seed=n)
    for rows, scale in ((None, None), (0, None), (n // 2, None),
                        (None, "big"), (0, "small")):
        s = _QL_SCALE[scale][dtype] if scale else 1.0
        dt = torch.tensor(d * s, dtype=dtype)[None]
        et = torch.tensor(e * s, dtype=dtype)[None]
        lam, steps = _sterf_in_rows(dt.to(cuda_device), et.to(cuda_device),
                                    rows)
        lam2, steps2 = tsterf.sterf_plain(dt, et)
        np.testing.assert_allclose(lam.cpu().numpy(), lam2.numpy(), rtol=0,
                                   atol=_sterf_bar(d, e, dtype) * s,
                                   err_msg=f"rows={rows} scale={scale}")
        assert int(steps[0]) > 0 and int(steps2[0]) > 0


@pytest.mark.gpu
def test_sterf_batched_equals_looped_bitwise(cuda_device):
    """Batched == looped, and the same bits with (d, e) in shared memory,
    in device memory, or moving into shared memory midway."""
    D = np.stack([make_family("normal", 120, seed=s)[0] for s in range(5)])
    E = np.stack([make_family("normal", 120, seed=s)[1] for s in range(5)])
    d = torch.tensor(D, device=cuda_device)
    e = torch.tensor(E, device=cuda_device)
    lam, steps = sterf_cuda(d, e)
    for rows in (0, 1, 37, 119, 120):
        lr, sr = _sterf_in_rows(d, e, rows)
        assert torch.equal(lr, lam) and torch.equal(sr, steps)
    for b in range(5):
        lb, sb = sterf_cuda(d[b:b + 1], e[b:b + 1])
        assert torch.equal(lb[0], lam[b]) and int(sb[0]) == int(steps[b])


@pytest.mark.gpu
def test_sterf_chain_probe_is_the_kernels_rotation(cuda_device):
    """The chain probe's one pass over its register rows is the kernel's
    first sweep, bit for bit: the same rotations and the same (d, e) after
    one outer step of a matrix whose first split is its last row.  Longer
    runs count reps x PROBE_ROWS rotations and stay finite."""
    U = qlk.PROBE_ROWS
    d, e = make_family("normal", U + 1, seed=7)
    dt = torch.tensor(d, device=cuda_device)
    et = torch.tensor(e, device=cuda_device)
    pd, pe, rot, cycles, ok = qlk.chain_probe_cuda(dt, et, 1)
    kd, ke, ksteps = qlk._launch(dt[None], et[None], 1)
    assert int(rot) == int(ksteps[0]) == U and int(ok) == 1
    assert torch.equal(pd, kd[0]) and torch.equal(pe, ke[0])
    assert int(cycles) > 0
    pd, pe, rot, cycles, ok = qlk.chain_probe_cuda(dt, et, 1000)
    assert int(rot) == 1000 * U and int(cycles) > 0 and int(ok) == 1
    assert bool(torch.isfinite(pd).all() and torch.isfinite(pe).all())


# ---- the deflation chain ---------------------------------------------------

def _chain_levels(family, n, dtype=torch.float64):
    """Every level's chain inputs (d, z, R, small, tol) of the port's plain
    CPU solve of ``family`` at n (seed 0, leaf 32)."""
    got = []
    real = tmerge._deflate_level

    def spy(d, z, R, small, tol, *, budget):
        got.append((d, z, R, small, tol))
        return real(d, z, R, small, tol, budget=budget)

    d, e = make_family(family, n, seed=0)
    tmerge._deflate_level = spy
    try:
        eigvalsh_tridiagonal_batch(d[None], e[None], leaf=32, dtype=dtype,
                                   device="cpu")
    finally:
        tmerge._deflate_level = real
    return got


def _chain_edges(dtype):
    """One-lane chains at the edges (see tests/test_torch_deflate_chain.py):
    a rotation the CPU's parallel head misses, K = 2, all poles small, a
    small first pole, a tau == 0 pair."""
    cases = [([0, 0, 0.01, 0.02, 0.03, 1.0], [1, 0.01, 0.01, 0.01, 0.01, 0.01],
              [0] * 6, 1e-3),
             ([1.0, 1.0], [0.6, 0.8], [0, 0], 1e-12),
             (np.linspace(0, 1, 40), np.zeros(40), [1] * 40, 1e-3),
             ([0.5, 0.5, 0.5, 0.7], [0, 0.6, 0.8, 0.1], [1, 0, 0, 0], 1e-6),
             ([1.0, 1.0, 1.0, 2.0], [0, 0, 0.5, 0.5], [0] * 4, 1e-6)]
    out = []
    for k, (d, z, small, tol) in enumerate(cases):
        K = len(d)
        R = torch.tensor(np.random.default_rng(k).standard_normal((1, 3, K)),
                         dtype=dtype)
        out.append((torch.tensor([d], dtype=dtype),
                    torch.tensor([z], dtype=dtype), R,
                    torch.tensor([small], dtype=torch.bool),
                    torch.tensor([tol], dtype=dtype)))
    return out


def _same_bits(a, b):
    """Equal bit for bit (a float's sign of zero included)."""
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(
        a.dtype)
    if view is None:
        return torch.equal(a, b)
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def test_cpu_tensors_take_the_plain_chain():
    lv = _chain_levels("glued_wilkinson", 256)[1]
    before = deflate_chain_cuda.launches
    got = ops.deflate_chain_batched(*lv)
    for a, b in zip(got, tmerge._close_pole_scan(*lv)):
        assert _same_bits(a, b)
    assert (got[3] & ~lv[3]).any()                 # rotations fired
    assert deflate_chain_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        deflate_chain_cuda(*lv)


def _card_chain_levels(family, n, dtype, device):
    """{K: (d, z, small, tol)} of every level of the port's card solve of
    ``family`` at n (seed 0)."""
    got = {}
    real = tmerge._deflate_level

    def spy(d, z, R, small, tol, *, budget):
        got[d.shape[1]] = (d, z, small, tol)
        return real(d, z, R, small, tol, budget=budget)

    d, e = make_family(family, n, seed=0)
    tmerge._deflate_level = spy
    try:
        eigvalsh_tridiagonal(d, e, dtype=dtype, device=device)
    finally:
        tmerge._deflate_level = real
    return got


CHAIN_ROWS = (1, 3, 4, 5, 32, 33, 64, None)       # None: r = K


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_deflate_chain_matches_plain_chain_on_card(cuda_device, dtype):
    """The kernel against the plain chain run on the card (torch.hypot is
    CUDA's hypot there), bit for bit on d, z, R and the mask, on both
    routes (the fused chain and the split one: list, then rows): every
    level of a glued-Wilkinson and a uniform n = 1024 solve, the top
    glued level with R = I (r = K = 1024, the lazy and full baselines'
    rows), the edge cases, and the K = 512, 2048 and 4096 levels of a
    glued n = 4096 card solve with random R of r = 1, 3, 4, 5, 32, 33, 64
    and K rows.  A check that passed a zeroed R, or an R with a rotated
    column swapped with its neighbour, would pass anything: both must
    fail."""
    glued = _chain_levels("glued_wilkinson", 1024, dtype)
    cases = glued + _chain_levels("uniform", 1024, dtype) + _chain_edges(
        dtype)
    d, z, _, small, tol = glued[-1]
    cases.append((d, z, torch.eye(d.shape[1], dtype=dtype)[None], small, tol))
    cases = [[t.to(cuda_device) for t in case] for case in cases]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    big = _card_chain_levels("glued_wilkinson", 4096, dtype, cuda_device)
    for K in (512, 2048, 4096):
        d, z, small, tol = big[K]
        for r in CHAIN_ROWS:
            R = torch.randn((d.shape[0], r or K, K), dtype=dtype,
                            device=cuda_device, generator=gen)
            cases.append([d, z, R, small, tol])
    rotations = 0
    for on in cases:
        W, r, K = on[2].shape
        want = tmerge._close_pole_scan(*on)
        for route in ("fused", "split"):
            before = deflate_chain_cuda.launches
            got = dck._launch(*on, dck._shape(W, r, K, dtype, route))
            assert deflate_chain_cuda.launches == before + 1
            for name, a, b in zip("d z R deflated".split(), got, want):
                assert _same_bits(a, b), (route, name, (W, r, K))
        rotations += int((got[3] & ~on[3]).sum())
        if r == K == 4096:
            fired = torch.nonzero(got[3][0] & ~on[3][0])[:, 0]
            assert fired.numel() > 0
            p, f = int(fired[0]), int(fired[0]) + 1
            swapped = got[2].clone()
            swapped[..., [p, f]] = got[2][..., [f, p]]
            assert not _same_bits(swapped, want[2])
            assert not _same_bits(torch.zeros_like(got[2]), want[2])
    assert rotations > 50
    # The wrapper's own route: the split one from SPLIT_MIN_R rows.
    before = deflate_chain_cuda.apply_launches
    deflate_chain_cuda(*cases[-1])
    deflate_chain_cuda(*cases[-8])
    assert deflate_chain_cuda.apply_launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "split"])
def test_deflate_chain_batched_equals_one_lane_bitwise(cuda_device, route):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    for lv in _chain_levels("glued_wilkinson", 1024):
        d, z, _, small, tol = (t.to(cuda_device) for t in lv)
        W, K = d.shape
        for r in (3, 33):
            R = torch.randn((W, r, K), dtype=d.dtype, device=cuda_device,
                            generator=gen)
            on = (d, z, R, small, tol)
            full = dck._launch(*on, dck._shape(W, r, K, d.dtype, route))
            for w in range(W):
                one = dck._launch(*(t[w:w + 1] for t in on),
                                  dck._shape(1, r, K, d.dtype, route))
                for a, b in zip(one, full):
                    assert _same_bits(a[0], b[w])


@pytest.mark.gpu
def test_deflate_chain_once_per_level_and_no_host_sync(cuda_device):
    """One launch per merge level of a solve, ``deflate_budget`` a no-op
    on the card, and no device-to-host sync in ``_deflate_level`` on CUDA
    tensors (torch's sync debug mode raises on one)."""
    d, e = make_family("glued_wilkinson", 4096, seed=0)
    before = deflate_chain_cuda.launches
    lam = eigvalsh_tridiagonal(d, e)
    assert deflate_chain_cuda.launches - before == 7     # 4096 = 32 * 2^7
    assert torch.equal(lam, eigvalsh_tridiagonal(d, e, deflate_budget=0))
    on = [t.to(cuda_device) for t in _chain_levels("glued_wilkinson",
                                                   1024)[2]]
    want = tmerge._deflate_level(*on, budget=64)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tmerge._deflate_level(*on, budget=64)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    for a, b in zip(got, want):
        assert _same_bits(a, b)


@pytest.mark.gpu
def test_merge_levels_make_no_host_sync_on_card(cuda_device, monkeypatch):
    """Past the leaf solve, every merge level of a solve (head, chain,
    root solve, resident merge, post-pass) runs without a device-to-host
    sync: the condition for capturing a level in a CUDA graph.  The leaf's
    batched torch.linalg.eigh runs with the check off."""
    d, e = make_family("uniform", 16384, seed=0)
    d_pad, e_pad, _, _ = tbr._pad_problem(
        torch.tensor(d, device=cuda_device)[None],
        torch.tensor(e, device=cuda_device)[None], 32)
    kw = dict(leaf=32, chunk=256, niter=16, use_zhat=True,
              return_boundary=False, tol_factor=8.0, stream_threshold=0,
              deflate_budget=64, resident_threshold=2048)
    want = tbr._br_dc_padded_batch(d_pad, e_pad, None, **kw)
    leaf_solve = tbr._leaf_solve

    def leaf_unchecked(*a, **k):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return leaf_solve(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(tbr, "_leaf_solve", leaf_unchecked)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbr._br_dc_padded_batch(d_pad, e_pad, None, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert _same_bits(got[0], want[0])


@pytest.mark.gpu
def test_deflate_chain_probe_runs_the_window_step(cuda_device):
    d, z, _, small, tol = (t.to(cuda_device)
                           for t in _chain_levels("glued_wilkinson", 1024)[0])
    cycles, fires = dck.chain_probe_cuda(d[0], z[0], small[0],
                                         float(tol[0]), 1000)
    assert int(cycles) > 0 and 0 <= int(fires) <= 1000


# ---- batched == looped through the whole solve ------------------------------

def _spy_solve(monkeypatch, run):
    """Run ``run()`` with every leaf solve's outputs and every level's merge
    inputs, chain inputs and outputs and results recorded in call order:
    [(stage, level, {name: tensor})]; the leaf's tensors lead with the
    problem axis, the rest with the lane axis (problem-major)."""
    log = []
    level = [0]
    leaf_solve, assemble = tbr._leaf_solve, tmerge._merge_assemble
    deflate, merge_level = tmerge._deflate_level, tmerge.merge_level

    def leaf_spy(*a, **k):
        lam, rows = leaf_solve(*a, **k)
        log.append(("leaf solve", -1, {"lam": lam, "rows": rows}))
        return lam, rows

    def assemble_spy(dL, dR, zL, zR, R, rho, sgn, tol_factor):
        out = assemble(dL, dR, zL, zR, R, rho, sgn, tol_factor)
        z0 = torch.cat([zL, sgn[:, None] * zR], dim=1)
        log.append(("merge assemble", level[0], dict(
            zip("d z R small tol rho_eff".split(), out),
            torch_sum_z0sq=torch.sum(z0 * z0, dim=1))))
        return out

    def deflate_spy(*a, **k):
        out = deflate(*a, **k)
        log.append(("deflation chain", level[0],
                    dict(zip("d z R deflated".split(), out))))
        return out

    def level_spy(lam_pairs, z_inner, R, rho, sgn, **kw):
        log.append(("merge inputs", level[0], dict(
            lam_pairs=lam_pairs, z_inner=z_inner, R=R, rho=rho, sgn=sgn)))
        res = merge_level(lam_pairs, z_inner, R, rho, sgn, **kw)
        log.append(("merge result", level[0], res._asdict()))
        level[0] += 1
        return res

    with monkeypatch.context() as m:
        m.setattr(tbr, "_leaf_solve", leaf_spy)
        m.setattr(tmerge, "_merge_assemble", assemble_spy)
        m.setattr(tmerge, "_deflate_level", deflate_spy)
        m.setattr(tmerge, "merge_level", level_spy)
        out = run()
    return out, log


@pytest.mark.gpu
def test_batched_equals_looped_bitwise_on_card(cuda_device, monkeypatch):
    """``chip_smoke.py`` phase 4's problems (uniform n = 1000, B = 4, seed0
    = 7) as one batch and one at a time: every recorded tensor of problem
    b in the batch has the bits of the looped solve's.  The one tensor
    allowed to differ is ``torch.sum`` of the level's z0^2 (recorded, not
    used): the library reduction the merge head no longer runs.  The first
    tensor that differs is named, and every one is printed."""
    D, E = make_family_batch("uniform", 1000, 4, seed0=7)
    B = D.shape[0]
    bat, blog = _spy_solve(monkeypatch, lambda: eigvalsh_tridiagonal_batch(
        D, E).eigenvalues)
    report = []
    for b in range(B):
        one, olog = _spy_solve(monkeypatch,
                               lambda: eigvalsh_tridiagonal(D[b], E[b]))
        assert [e[:2] for e in olog] == [e[:2] for e in blog]
        for (stage, lvl, got), (_, _, want) in zip(blog, olog):
            for name, t in got.items():
                w = want[name]
                lanes = w.shape[0]
                part = t[b * lanes:(b + 1) * lanes]
                if not _same_bits(part, w):
                    diff = (float((part.double() - w.double()).abs().max())
                            if part.is_floating_point() else None)
                    report.append(f"problem {b}: {stage} level {lvl} {name} "
                                  f"max diff {diff}")
        if not _same_bits(bat[b], one):
            report.append(f"problem {b}: eigenvalues max diff "
                          f"{float((bat[b] - one).abs().max())}")
    print("[batched vs looped] " + ("; ".join(report) if report else
                                    "every recorded tensor bitwise equal"))
    solve = [r for r in report if "torch_sum_z0sq" not in r]
    assert not solve, f"first difference: {solve[0]}"
