"""Atomic, checksummed checkpoints on the JAX package's on-disk format
(port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.manager import (CheckpointManager, all_steps,
                                            latest_step, restore_tree,
                                            save_tree)

__all__ = ["CheckpointManager", "all_steps", "latest_step", "restore_tree",
           "save_tree"]
