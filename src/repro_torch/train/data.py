"""The GNN epoch iterator (own copy of the GNN part of
``repro/train/data.py``): the paper's synchronous minibatch creation
(Algorithm 2, line 4) without the pipeline, the source of
``DistTrainer.train_epochs(pipeline=None)``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.configs.gnn import GNNConfig
from repro_torch.graph.partition import PartitionSet
from repro_torch.graph.sampling import epoch_minibatches, pad_schedule


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
