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
    tests/test_kernels.py, f32 scaled by eps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import eigvalsh_tridiagonal, make_family  # noqa: E402
from repro_torch.core import secular as tsec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fused_update import secular_postpass_cuda  # noqa: E402
from repro_torch.kernels.resident_merge import resident_merge_cuda  # noqa: E402
from repro_torch.kernels.secular_roots import secular_solve_cuda  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def test_import_loads_neither_jax_nor_repro_and_needs_no_nvcc():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
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
    z /= np.linalg.norm(z, axis=1, keepdims=True)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,K,kprime", [(3, 130, 101), (2, 1030, 700),
                                        (1, 16, 1)])
def test_kernels_match_plain_on_card(cuda_device, dtype, B, K, kprime):
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
