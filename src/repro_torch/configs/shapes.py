"""Assigned input-shape set (identical for every LM arch; see DESIGN.md).

    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> serve_prefill
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                   KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid only

Reduced variants (same structure, tiny dims) feed the per-arch smoke tests.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SMOKE_SHAPES = {
    "train": ShapeSpec("smoke_train", 64, 2, "train"),
    "prefill": ShapeSpec("smoke_prefill", 64, 2, "prefill"),
    "decode": ShapeSpec("smoke_decode", 64, 2, "decode"),
}


def shape_applicable(cfg, shape: ShapeSpec) -> bool:
    """long_500k requires sub-quadratic context state (skip rule)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
