"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch, numpy and the standard library only -- never ``jax`` and
nothing of ``repro``.  Ported so far: the full-spectrum boundary-row
solve (``repro_torch.core.eigvalsh_tridiagonal``) with its three merge
kernels, and the Sturm-count path -- range, edges and bisect solves,
``certify=True`` and ``precision="mixed"`` -- with the Sturm-count kernel,
and the paper's comparison points -- the sterf, lazy, full and eigh
methods and the ``fused=False`` two-pass conquer -- with the two-pass
weight and row-update kernels and a QL kernel (``repro_torch.kernels``).
"""

from repro_torch.core import (eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br,
                              eigvalsh_tridiagonal_range)

__all__ = ["eigvalsh_tridiagonal", "eigvalsh_tridiagonal_batch",
           "eigvalsh_tridiagonal_br", "eigvalsh_tridiagonal_range"]
