"""The distributed conquer on a CUDA card (``gpu`` marker; run with
``python -m pytest -m gpu --noconftest tests/test_torch_dist_card.py``:
the card's machine has no JAX, and this file imports none).

P shards run on one card through ``make_solver_mesh(P, devices=["cuda:0"]
* P)``.  Held here:

  * the root-window entry of ``csrc/secular_roots.cu`` equals the same
    columns of the full launch bit for bit, at starts on and off the
    block's 32-root grid, and its plain version
    (``secular.secular_solve_window_batched``) at the kernel bar of
    tests/test_torch_kernels.py;
  * a sharded solve equals the single-device solve on the card bit for
    bit (n = 4096 at P = 2 and 4; a B = 8 x 2048 batch with boundary rows
    at P = 4), launching the window entry where a cooperative level is
    above the resident threshold, and without a host sync past the
    leaves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (eigvalsh_tridiagonal,  # noqa: E402
                              eigvalsh_tridiagonal_batch, make_family,
                              make_family_batch)
from repro_torch.core import br_dc as tbr  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.kernels.secular_roots import (  # noqa: E402
    secular_solve_cuda, secular_solve_window_cuda)
from repro_torch.launch.mesh import make_solver_mesh  # noqa: E402

from _torch_threads import _one_torch_thread  # noqa: E402,F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _mesh(P):
    return make_solver_mesh(P, devices=["cuda:0"] * P)


def _same_bits(a, b):
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(
        a.dtype)
    if view is None:
        return torch.equal(a, b)
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def _roots_problem(B, K, kprime, dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((B, K)), axis=1)
    d[:, kprime:] += 10.0
    z = rng.standard_normal((B, K))
    z[:, kprime:] = 0.0
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (t(d), t(z * z), torch.full((B,), 0.7, dtype=dtype, device=device),
            torch.full((B,), kprime, dtype=torch.int32, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_window_entry_equals_full_columns_and_plain(cuda_device, dtype):
    B, K, kprime = 3, 4096, 3001
    d, z2, rho, kp = _roots_problem(B, K, kprime, dtype, cuda_device)
    niter = 16 if dtype == torch.float64 else 10
    fo, ft = secular_solve_cuda(d, z2, rho, kp, niter=niter)
    before = secular_solve_window_cuda.launches
    windows = [(0, K), (1024, 1024), (3072, 1024), (17, 1000), (2990, 50),
               (4000, 96)]
    for start, nroots in windows:
        o, t = secular_solve_window_cuda(d, z2, rho, kp, start, nroots,
                                         niter=niter)
        assert o.shape == t.shape == (B, nroots)
        assert torch.equal(o, fo[:, start:start + nroots]), (start, nroots)
        assert _same_bits(t, ft[:, start:start + nroots]), (start, nroots)
    assert secular_solve_window_cuda.launches - before == len(windows)
    o, t = secular_solve_window_cuda(d, z2, rho, kp, 1024, 2048, niter=niter)
    po, pt = tsec.secular_solve_window_batched(d, z2, rho, kp, 1024, 2048,
                                               niter=niter)
    scale = (np.finfo(np.float32).eps / np.finfo(np.float64).eps
             if dtype == torch.float32 else 1.0)
    torch.testing.assert_close(
        tsec.secular_eigenvalues(d, o, t), tsec.secular_eigenvalues(d, po, pt),
        atol=1e-13 * scale, rtol=0)
    with pytest.raises(ValueError, match="window"):
        secular_solve_window_cuda(d, z2, rho, kp, K - 10, 20, niter=niter)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [2, 4])
def test_sharded_equals_single_device_on_card(cuda_device, P):
    d, e = make_family("uniform", 4096, seed=0)
    single = eigvalsh_tridiagonal(d, e, mesh=1)
    before = secular_solve_window_cuda.launches
    got = eigvalsh_tridiagonal(d, e, mesh=_mesh(P))
    torch.cuda.synchronize()
    # The top level (K = 4096, above the resident threshold) is the one
    # cooperative level that solves its roots in windows: P launches.
    assert secular_solve_window_cuda.launches - before == P
    assert _same_bits(got, single)
    d, e = make_family("glued_wilkinson", 4096, seed=0)
    assert _same_bits(eigvalsh_tridiagonal(d, e, mesh=_mesh(P)),
                      eigvalsh_tridiagonal(d, e, mesh=1))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 2000])
def test_sharded_batch_with_rows_equals_single_device_on_card(cuda_device,
                                                              n):
    """B = 8 problems with boundary rows at P = 4; n = 2000 pads, so the
    last original row rides the tracked third slot."""
    D, E = make_family_batch("normal", n, 8)
    one = eigvalsh_tridiagonal_batch(D, E, return_boundary=True, mesh=1)
    four = eigvalsh_tridiagonal_batch(D, E, return_boundary=True,
                                      mesh=_mesh(4))
    for a, b in zip(one[:3], four[:3]):
        assert _same_bits(a, b)


@pytest.mark.gpu
def test_sharded_levels_make_no_host_sync_on_card(cuda_device, monkeypatch):
    """Past the leaf solves, the sharded tree -- halo, subtree levels, the
    state all-gather, the cooperative levels and their windows -- runs
    without a device-to-host sync, as the single-device levels do."""
    d, e = make_family("uniform", 8192, seed=1)
    d_pad, e_pad, N, _ = tbr._pad_problem(
        torch.tensor(d, device=cuda_device)[None],
        torch.tensor(e, device=cuda_device)[None], 32)
    P, Np = 4, N // 4
    d_locs = [d_pad[:, p * Np:(p + 1) * Np].contiguous() for p in range(P)]
    e_locs = [e_pad[:, p * Np:(p + 1) * Np].contiguous() for p in range(P)]
    kw = dict(leaf=32, chunk=256, niter=16, use_zhat=True,
              return_boundary=False, tol_factor=8.0, stream_threshold=0,
              deflate_budget=64, resident_threshold=2048, fused=True)
    want = tbr._br_dc_sharded_batch(d_locs, e_locs, [None] * P, **kw)
    single = tbr._br_dc_padded_batch(d_pad, e_pad, None, **kw)
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
        got = tbr._br_dc_sharded_batch(d_locs, e_locs, [None] * P, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert _same_bits(got[0][0], want[0][0])
    assert _same_bits(got[0][0], single[0])
