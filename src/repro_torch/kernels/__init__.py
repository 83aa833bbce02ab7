"""Hand-written CUDA kernels of the port (sources in ``repro_torch/csrc``).

  secular_roots.py   -- batched secular root solve (and its root window)
  fused_update.py    -- fused conquer post-pass (weights + row update)
  resident_merge.py  -- single-launch small-K merge (solve + post-pass)
  sturm_count.py     -- batched Sturm counts (and their derivative sums)
  zhat.py            -- log-space weights of the two-pass conquer
  boundary_update.py -- row update of the two-pass conquer, any row count
  sterf.py           -- implicit-shift QL iteration, one warp per problem
  deflate_chain.py   -- DLAED2 close-pole deflation chain, one warp per lane

Each wrapper builds its kernel on first use (``_build``), launches it on
the current stream and counts its launches (``<wrapper>.launches``).
``ops.py`` routes by device: plain torch for CPU tensors, the kernel for
CUDA tensors; ``ref.py`` holds the dense oracles.
"""

from repro_torch.kernels.boundary_update import boundary_rows_update_cuda
from repro_torch.kernels.deflate_chain import deflate_chain_cuda
from repro_torch.kernels.fused_update import secular_postpass_cuda
from repro_torch.kernels.ops import (
    FUSED_MAX_ROWS,
    boundary_rows_update,
    boundary_rows_update_batched,
    count_and_newton_batched,
    deflate_chain_batched,
    resolve_niter,
    secular_merge_resident,
    secular_merge_resident_batched,
    secular_postpass,
    secular_postpass_batched,
    secular_solve,
    secular_solve_batched,
    secular_solve_window_batched,
    sterf_batched,
    sturm_count_batched,
    zhat_reconstruct,
    zhat_reconstruct_batched,
)
from repro_torch.kernels.resident_merge import resident_merge_cuda
from repro_torch.kernels.secular_roots import (secular_solve_cuda,
                                               secular_solve_window_cuda)
from repro_torch.kernels.sterf import sterf_cuda
from repro_torch.kernels.sturm_count import (sturm_count_cuda,
                                             sturm_count_newton_cuda)
from repro_torch.kernels.zhat import zhat_reconstruct_cuda

__all__ = [
    "FUSED_MAX_ROWS", "boundary_rows_update", "boundary_rows_update_batched",
    "boundary_rows_update_cuda", "count_and_newton_batched",
    "deflate_chain_batched", "deflate_chain_cuda",
    "resident_merge_cuda", "resolve_niter", "secular_merge_resident",
    "secular_merge_resident_batched", "secular_postpass",
    "secular_postpass_batched", "secular_postpass_cuda", "secular_solve",
    "secular_solve_batched", "secular_solve_cuda",
    "secular_solve_window_batched", "secular_solve_window_cuda",
    "sterf_batched",
    "sterf_cuda", "sturm_count_batched", "sturm_count_cuda",
    "sturm_count_newton_cuda", "zhat_reconstruct",
    "zhat_reconstruct_batched", "zhat_reconstruct_cuda",
]
