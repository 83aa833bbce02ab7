"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch, numpy and the standard library only -- never ``jax`` and
nothing of ``repro``.  Ported so far: the full-spectrum boundary-row
solve (``repro_torch.core.eigvalsh_tridiagonal``) with its three merge
kernels and the deflation chain kernel; the Sturm-count path -- range,
edges and bisect solves, ``certify=True`` and ``precision="mixed"`` --
with the Sturm-count kernels; the paper's comparison points -- the sterf,
lazy, full and eigh methods and the ``fused=False`` two-pass conquer --
with the two-pass weight and row-update kernels and a QL kernel
(``repro_torch.kernels``); the eigensolver service
(``repro_torch.serve``, ``repro_torch.runtime``); the autotuner and its
route-time consult (``repro_torch.core.plan.tune``); and the spectral
estimates and optimizers (``repro_torch.spectral``: Lanczos, HVP and
Gauss-Newton products, SLQ as ``kind="slq"``, extremal edges;
``repro_torch.optim``: sgd, adamw, adafactor and the spectral
learning-rate governor).
"""

from repro_torch.core import (eigvalsh_tridiagonal,
                              eigvalsh_tridiagonal_batch,
                              eigvalsh_tridiagonal_br,
                              eigvalsh_tridiagonal_range)

__all__ = ["eigvalsh_tridiagonal", "eigvalsh_tridiagonal_batch",
           "eigvalsh_tridiagonal_br", "eigvalsh_tridiagonal_range"]
