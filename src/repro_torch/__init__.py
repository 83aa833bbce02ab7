"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch, numpy and the standard library only -- never ``jax`` and
nothing of ``repro``.  This slice ports the main path: the full-spectrum
boundary-row solve (``repro_torch.core.eigvalsh_tridiagonal``) with its
three merge kernels (``repro_torch.kernels``).
"""

from repro_torch.core import (eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br)

__all__ = ["eigvalsh_tridiagonal", "eigvalsh_tridiagonal_batch",
           "eigvalsh_tridiagonal_br"]
