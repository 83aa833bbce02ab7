"""Optimizers and the spectral learning-rate governor (port of
``repro.optim``): functional on trees of tensors (``repro_torch.tree``)."""

from repro_torch.optim.optimizers import (OPTIMIZERS, Optimizer, adafactor,
                                          adamw, get_optimizer, sgd)
from repro_torch.optim.spectral_adapt import SpectralGovernor

__all__ = ["OPTIMIZERS", "Optimizer", "SpectralGovernor", "adafactor",
           "adamw", "get_optimizer", "sgd"]
