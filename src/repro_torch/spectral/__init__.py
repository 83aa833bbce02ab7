"""Spectral estimates of curvature operators (port of ``repro.spectral``):
Lanczos tridiagonalization of tree-valued operators, Hessian and
Gauss-Newton vector products on ``torch.func``, and stochastic Lanczos
quadrature and extremal edges on top of the port's eigensolver."""

from repro_torch.spectral.hvp import make_gnvp, make_hvp
from repro_torch.spectral.lanczos import lanczos_tridiag, lanczos_tridiag_batch
from repro_torch.spectral.slq import (SpectralEstimate, edges_from_tridiag,
                                      sharpness, slq_spectrum,
                                      spectral_edges)

__all__ = ["SpectralEstimate", "edges_from_tridiag", "lanczos_tridiag",
           "lanczos_tridiag_batch", "make_gnvp", "make_hvp", "sharpness",
           "slq_spectrum", "spectral_edges"]
