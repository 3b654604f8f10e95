"""Data pipeline substrate (own copy of ``repro/train/data.py``).

LM side: a deterministic synthetic token stream (Markov bigram mixture,
learnable; the reference's draws bit for bit for every ``(seed, step)``)
and a host-side prefetching iterator.  The reference's ``shard_batch``
places a batch on a jax mesh; its counterpart waits for the
``torch.distributed`` backend.

GNN side: the epoch iterator, the paper's synchronous minibatch creation
(Algorithm 2, line 4) without the pipeline, the source of
``DistTrainer.train_epochs(pipeline=None)``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.gnn import GNNConfig
from repro_torch.graph.partition import PartitionSet
from repro_torch.graph.sampling import epoch_minibatches, pad_schedule


class TokenStream:
    """Deterministic synthetic LM data: order-1 Markov chain with noise.

    Every batch is reproducible from (seed, step), no state to checkpoint
    beyond the step counter.  The draws are numpy's, as the reference's;
    the batch is ``{"tokens", "labels"}`` int32 tensors on ``device``
    (the card unless the caller asks for the CPU).
    """

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 signal: float = 0.8, device=None):
        from repro_torch.device import resolve_device
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.signal = signal
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.table = rng.integers(0, vocab_size, vocab_size).astype(np.int32)
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, T, V = self.batch, self.seq, self.vocab_size
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.integers(0, V, (B, T))
        coin = rng.random((B, T)) < self.signal
        for t in range(1, T):
            nxt = self.table[toks[:, t - 1]]
            toks[:, t] = np.where(coin[:, t], nxt, noise[:, t])
        labels = np.roll(toks, -1, axis=1)
        return {"tokens": torch.from_numpy(toks).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-side background prefetch of a batch iterator (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def gnn_epoch_iterator(ps: PartitionSet, cfg: GNNConfig,
                       rng: np.random.Generator
                       ) -> Iterator[Tuple[dict, dict]]:
    """Synchronized per-rank host minibatches for one epoch, each with
    ``{"imbalance", "minibatches"}``.  The shuffle and every draw take
    ``rng`` in turn, as the reference's do.  Ranks with fewer batches
    contribute empty (fully masked) ones; the load imbalance is reported,
    not hidden (paper §4.4)."""
    from repro_torch.train.gnn_trainer import sample_step

    per_rank = [epoch_minibatches(ps.parts[r], cfg.batch_size, rng)
                for r in range(ps.num_parts)]
    schedule = pad_schedule(per_rank)
    M = len(schedule)
    imbalance = (M - min(len(b) for b in per_rank)) / max(M, 1)
    for seeds in schedule:
        yield sample_step(ps, cfg, seeds, rng), {"imbalance": imbalance,
                                                 "minibatches": M}
