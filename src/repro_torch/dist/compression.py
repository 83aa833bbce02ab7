"""int8 quantization of the solver's boundary rows: port of
``repro.dist.compression.quantize_lanes`` / ``dequantize_lanes``.

The compressed halo (``compress_halo=True``) sends the sharded tree's
boundary rows across the subtree->cooperative all-gather as an int8
payload plus one float32 scale per (problem, slot) lane.  The transfer is
one-shot, so there is no residual to carry into a next step: the bias is
one quantization step.  The gradient half (``CompressionState``,
``compressed_cross_pod_mean``) comes with the trainer's multi-device
branch.
"""

from __future__ import annotations

import torch

_QMAX = 127.0


def quantize_lanes(x):
    """int8 quantization over the last axis, one float32 scale per
    leading-dims lane: ``(q int8, scale float32 (..., 1))``.

    Staged in float32 whatever ``x``'s dtype (an int8 payload carries
    under 8 bits, so a float32 scale over-represents it for float64 too),
    with a ``tiny`` floor on the scale; ``torch.round`` rounds half to
    even as ``jnp.round`` does, so the payload equals the JAX package's
    bit for bit."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(dim=-1, keepdim=True) / _QMAX
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_lanes(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_lanes` up to the quantization error, in
    the caller's ``dtype`` (a float32 tree stays float32)."""
    return (q.to(torch.float32) * scale).to(dtype)
