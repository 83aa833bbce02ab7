"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

  secular_roots.py   -- batched secular root solve
  fused_update.py    -- fused conquer post-pass (weights + row update)
  resident_merge.py  -- single-launch small-K merge (solve + post-pass)
  sturm_count.py     -- batched Sturm counts (and their derivative sums)

Each wrapper builds its kernel on first use (``_build``), launches it on
the current stream and counts its launches (``<wrapper>.launches``).
``ops.py`` routes by device: plain torch for CPU tensors, the kernel for
CUDA tensors; ``ref.py`` holds the dense oracles.
"""

from repro_torch.kernels.fused_update import secular_postpass_cuda
from repro_torch.kernels.ops import (
    count_and_newton_batched,
    resolve_niter,
    secular_merge_resident,
    secular_merge_resident_batched,
    secular_postpass,
    secular_postpass_batched,
    secular_solve,
    secular_solve_batched,
    sturm_count_batched,
)
from repro_torch.kernels.resident_merge import resident_merge_cuda
from repro_torch.kernels.secular_roots import secular_solve_cuda
from repro_torch.kernels.sturm_count import (sturm_count_cuda,
                                             sturm_count_newton_cuda)

__all__ = [
    "count_and_newton_batched", "resident_merge_cuda", "resolve_niter",
    "secular_merge_resident", "secular_merge_resident_batched",
    "secular_postpass", "secular_postpass_batched", "secular_postpass_cuda",
    "secular_solve", "secular_solve_batched", "secular_solve_cuda",
    "sturm_count_batched", "sturm_count_cuda", "sturm_count_newton_cuda",
]
