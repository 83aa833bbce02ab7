"""repro_torch.dist -- sharding rules, int8 compression and the solver
tree's collectives (port of ``repro.dist``).

  sharding.py     -- logical parameter/batch/cache sharding specs for the
                     (pod, data, model) meshes as ``DTensor`` placements,
                     the activation-constraint switches used by models/
                     and launch/, and the solver tree's halo and
                     all-gathers over the shards of a ``SolverMesh``.
  compression.py  -- int8 error-feedback gradient compression for the
                     slow cross-pod links, and the int8 boundary rows of
                     the compressed halo.
  host_staged.py  -- DTensor's collectives of ranks that share one card
                     over gloo, staged through host memory.
"""

from repro_torch.dist.compression import (CompressionState,
                                          compressed_cross_pod_mean,
                                          dequantize_lanes,
                                          init_compression_state,
                                          quantize_lanes)
from repro_torch.dist.sharding import (SOLVER_AXIS, Sharding, batch_sharding,
                                       cache_shardings, constrain_batch_acts,
                                       constrain_seq_model_acts,
                                       distribute_tree, dp_axis_extent,
                                       gather_lanes, gather_tree_state,
                                       get_activation_mesh, halo_from_left,
                                       logical_param_specs,
                                       model_axis_extent, opt_shardings,
                                       param_shardings, placements,
                                       set_activation_mesh, set_manual_axes,
                                       set_sequence_parallel)

__all__ = [
    "CompressionState", "SOLVER_AXIS", "Sharding", "batch_sharding",
    "cache_shardings", "compressed_cross_pod_mean", "constrain_batch_acts",
    "constrain_seq_model_acts", "dequantize_lanes", "distribute_tree",
    "dp_axis_extent", "gather_lanes", "gather_tree_state",
    "get_activation_mesh", "halo_from_left", "init_compression_state",
    "logical_param_specs", "model_axis_extent", "opt_shardings",
    "param_shardings", "placements", "quantize_lanes",
    "set_activation_mesh", "set_manual_axes", "set_sequence_parallel",
]
