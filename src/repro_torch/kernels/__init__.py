"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

  secular_roots.py   -- batched secular root solve
  fused_update.py    -- fused conquer post-pass (weights + row update)
  resident_merge.py  -- single-launch small-K merge (solve + post-pass)

Each wrapper builds its kernel on first use (``_build``), launches it on
the current stream and counts its launches (``<wrapper>.launches``).
``ops.py`` routes by device: plain torch for CPU tensors, the kernel for
CUDA tensors; ``ref.py`` holds the dense oracles.
"""

from repro_torch.kernels.fused_update import secular_postpass_cuda
from repro_torch.kernels.ops import (
    resolve_niter,
    secular_merge_resident,
    secular_merge_resident_batched,
    secular_postpass,
    secular_postpass_batched,
    secular_solve,
    secular_solve_batched,
)
from repro_torch.kernels.resident_merge import resident_merge_cuda
from repro_torch.kernels.secular_roots import secular_solve_cuda

__all__ = [
    "resident_merge_cuda", "resolve_niter",
    "secular_merge_resident", "secular_merge_resident_batched",
    "secular_postpass", "secular_postpass_batched", "secular_postpass_cuda",
    "secular_solve", "secular_solve_batched", "secular_solve_cuda",
]
