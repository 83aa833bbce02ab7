"""Architecture registry: one module per assigned architecture.

    from repro_torch.configs import get_config, get_smoke_config, ARCHS
    cfg = get_config("qwen3-0.6b")
"""

from __future__ import annotations

import importlib

ARCHS = (
    "whisper-small",
    "llama4-maverick-400b-a17b",
    "dbrx-132b",
    "minicpm3-4b",
    "deepseek-67b",
    "qwen3-0.6b",
    "qwen2-1.5b",
    "qwen2-vl-72b",
    "zamba2-7b",
    "mamba2-130m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "p") for a in ARCHS}


def _load(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _load(arch).config()


def get_smoke_config(arch: str):
    return _load(arch).smoke_config()


from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, ShapeSpec, shape_applicable  # noqa: E402

__all__ = ["ARCHS", "SHAPES", "SMOKE_SHAPES", "ShapeSpec", "get_config",
           "get_smoke_config", "shape_applicable"]
