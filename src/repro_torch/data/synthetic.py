"""Deterministic synthetic token source.

Structured enough that a model can actually learn (Zipfian unigram
distribution + short-range Markov coupling) and bit-reproducible for a
given (seed, step, host_shard): the stream is a pure function of its
coordinates, which is what makes elastic restarts and straggler re-issue
trivially consistent (no iterator state to checkpoint -- only the step).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_strength: float = 0.5

    def batch(self, step: int, shard: int, batch_size: int) -> dict:
        """(batch_size, seq_len) tokens + next-token labels."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        B, S, V = batch_size, self.seq_len, self.vocab_size
        # Zipf-ish unigram draw, clipped into vocab.
        base = rng.zipf(self.zipf_a, size=(B, S + 1)) % V
        # Markov coupling: with prob markov_strength, token t+1 is a
        # deterministic function of token t (learnable signal).
        nxt = (base[:, :-1] * 2654435761 + 12345) % V
        mask = rng.random((B, S)) < self.markov_strength
        toks = base[:, 1:].copy()
        toks[mask] = nxt[mask]
        tokens = np.concatenate([base[:, :1], toks[:, :-1]], axis=1)
        labels = toks
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32)}
