"""Host-sharded data pipeline with background prefetch (port copy of
``repro.data.pipeline``), and the dry run's abstract batches
(``synthetic_batch_specs``).

Each host process owns `host_batch = global_batch / num_shards`; the
multi-rank trainer draws the global batch on every rank (one shard) and
keeps its ``batch_sharding`` slice of it.  A background thread keeps
`prefetch` batches ahead of the training step; batches are a pure function
of (seed, step, shard) so resume-at-step-k is exact.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch

from repro_torch.data.synthetic import SyntheticTokens


def synthetic_batch_specs(cfg, shape):
    """The global batch of a dry-run cell as meta tensors (shapes and
    dtypes, nothing allocated): int32 tokens and labels (B, S), and
    bfloat16 ``frames`` (B, encoder_seq_len, d_model) for the
    encoder-decoder configs."""
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
        "labels": torch.empty((B, S), dtype=torch.int32, device="meta"),
    }
    if cfg.is_encdec:
        specs["frames"] = torch.empty((B, cfg.encoder_seq_len, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return specs


class DataPipeline:
    def __init__(self, source: SyntheticTokens, *, global_batch: int,
                 num_shards: int = 1, shard_id: int = 0,
                 prefetch: int = 2, start_step: int = 0,
                 extra_fn=None):
        assert global_batch % num_shards == 0
        self.source = source
        self.host_batch = global_batch // num_shards
        self.shard_id = shard_id
        self.prefetch = prefetch
        self.step = start_step
        self.extra_fn = extra_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _produce(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch(step, self.shard_id, self.host_batch)
            if self.extra_fn is not None:
                batch.update(self.extra_fn(step, self.shard_id,
                                           self.host_batch))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
        return self

    def __iter__(self) -> Iterator[dict]:
        self.start()
        while True:
            step, batch = self._q.get()
            yield batch

    def stop(self):
        self._stop.set()
