"""repro_torch.dist -- the distributed conquer's collectives (port of the
solver half of ``repro.dist``).

  sharding.py     -- the solver tree's halo and all-gathers over the
                     shards of a ``launch.mesh.SolverMesh``.
  compression.py  -- int8 quantization of the boundary rows for the
                     compressed halo.

The trainer's parameter and activation shardings and the cross-pod
gradient compression are ROADMAP Queue 1 item 4's other half.
"""

from repro_torch.dist.compression import dequantize_lanes, quantize_lanes
from repro_torch.dist.sharding import (SOLVER_AXIS, gather_lanes,
                                       gather_tree_state, halo_from_left)

__all__ = ["SOLVER_AXIS", "dequantize_lanes", "gather_lanes",
           "gather_tree_state", "halo_from_left", "quantize_lanes"]
