"""Spectral learning-rate governor: eigenvalue-only curvature -> lr_scale
(port of ``repro.optim.spectral_adapt``).

The paper's motivating workflow (the application needs the eigenvalues
before deciding whether eigenvectors are necessary) as an optimizer
feature: every ``period`` steps the trainer measures lam_max of the
curvature operator, eigenvalues only, and the governor maps it to

    scale = min(1, target_sharpness / lam_max)

(2/eta stability control), held between probes.  ``probe`` runs the
partial-spectrum path (``repro_torch.spectral.sharpness``: the top Ritz
value of a Krylov tridiagonal by Sturm slicing), since lam_max is a
1-of-m eigenvalue problem.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np


@dataclasses.dataclass
class SpectralGovernor:
    target_sharpness: float = 100.0
    min_scale: float = 0.05
    period: int = 50
    ema: float = 0.7
    _lam_max: float = 0.0
    _scale: float = 1.0
    _probed: bool = False
    probes: int = 0

    def should_probe(self, step: int) -> bool:
        return step % self.period == 0

    def probe(self, matvec, params_like, generator, *, num_steps: int = 16,
              client=None) -> float:
        """Measure lam_max on the sliced extremal-edge path and update.

        One Lanczos probe (drawn from ``generator``) reduced to a single
        sliced eigenvalue solve; ``client`` routes that solve through the
        service as a ``kind="edges"`` request (the same bits).  The
        probe's wall time lands on ``SOLVE_COUNTER``'s probe gauge.
        Returns the new lr scale.
        """
        from repro_torch.core.br_dc import SOLVE_COUNTER
        from repro_torch.spectral.slq import sharpness
        t0 = time.perf_counter()
        lam = sharpness(matvec, params_like, generator, num_steps=num_steps,
                        client=client)
        SOLVE_COUNTER.record_probe(time.perf_counter() - t0)
        return self.update(lam)

    def probe_tridiag(self, alpha, beta, *, client=None) -> float:
        """Update from an already-built Krylov tridiagonal: only the k = 1
        sliced extremal solve runs here (directly or, with ``client``, as
        a ``kind="edges"`` request), and only it is timed onto the probe
        gauge."""
        from repro_torch.core.br_dc import SOLVE_COUNTER
        from repro_torch.spectral.slq import edges_from_tridiag
        t0 = time.perf_counter()
        _, hi = edges_from_tridiag(alpha, beta, k=1, client=client)
        SOLVE_COUNTER.record_probe(time.perf_counter() - t0)
        return self.update(float(np.max(hi)))

    def update(self, lam_max: float) -> float:
        lam_max = float(lam_max)
        if not math.isfinite(lam_max):
            # A diverged probe (nan/inf HVP) must not poison the EMA:
            # clamp hard to the floor and wait for a finite measurement.
            self._scale = self.min_scale
            return self._scale
        if not self._probed:
            # Explicit cold start: lam_max == 0.0 is a legitimate first
            # measurement (flat curvature), not "never probed".
            self._lam_max = lam_max
            self._probed = True
        else:
            self._lam_max = self.ema * self._lam_max + (1 - self.ema) * lam_max
        self.probes += 1
        if self._lam_max > 0:
            self._scale = max(self.min_scale,
                              min(1.0, self.target_sharpness / self._lam_max))
        else:
            # Flat or concave-down curvature estimate: nothing to damp.
            self._scale = 1.0
        return self._scale

    @property
    def scale(self) -> float:
        return self._scale

    @property
    def lam_max(self) -> float:
        return self._lam_max
