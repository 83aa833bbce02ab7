"""repro_torch.models -- the model zoo for the 10 assigned architectures
(port of ``repro.models``): the JAX package's parameter tree and block
bodies on torch, with ``params_from_numpy`` to carry its parameters
across."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_model,
    loss_fn,
    param_count,
    prefill,
)

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_model", "loss_fn", "param_count", "params_from_numpy",
           "prefill"]
