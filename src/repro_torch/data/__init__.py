"""Synthetic token data and the prefetching pipeline (port copies of
``repro.data``; batches are numpy, a pure function of (seed, step,
shard))."""

from repro_torch.data.pipeline import DataPipeline, synthetic_batch_specs
from repro_torch.data.synthetic import SyntheticTokens

__all__ = ["DataPipeline", "SyntheticTokens", "synthetic_batch_specs"]
