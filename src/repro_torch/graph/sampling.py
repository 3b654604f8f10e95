"""Minibatch block layout and the epoch's seed schedule (own copy of
``repro/graph/sampling.py``'s ``MinibatchBlocks``, ``layer_capacities``,
``epoch_minibatches`` and ``pad_schedule``).

Block layout for an L-layer GNN (seeds at layer L-1):
  layer_nodes[k]  [N_k]           VID_p per node (-1 pad); k=0 is input side
  node_mask[k]    [N_k]           valid
  nbr_idx[k]      [N_{k+1}, f_k]  indices INTO layer_nodes[k] (-1 pad);
                                  row r aggregates into layer_nodes[k+1][r]
  (dst nodes are a prefix of the finer layer's node list, so self features
  are read at the same positions.)

The blocks are host numpy arrays with fixed shapes; the sampler that
fills them is ``repro_torch.pipeline.vectorized_sampler``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.graph.partition import Partition


@dataclasses.dataclass
class MinibatchBlocks:
    layer_nodes: List[np.ndarray]   # coarse->fine: [0]=input layer
    node_mask: List[np.ndarray]
    nbr_idx: List[np.ndarray]       # len = num GNN layers
    seeds: np.ndarray               # [B] VID_p (solid), -1 pad
    seed_mask: np.ndarray
    labels: np.ndarray              # [B]

    @property
    def num_layers(self):
        return len(self.nbr_idx)


def layer_capacities(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Node capacity per layer, seeds outward; returned input-side first."""
    caps = [batch_size]
    for f in reversed(list(fanouts)):      # seeds sample fanouts[-1] first
        caps.append(caps[-1] * (1 + f))
    return caps[::-1]


def epoch_minibatches(part: Partition, batch_size: int,
                      rng: np.random.Generator) -> List[np.ndarray]:
    """Shuffled training seed batches (VID_p), one list per epoch."""
    train = np.flatnonzero(part.train_mask)
    rng.shuffle(train)
    return [train[i:i + batch_size]
            for i in range(0, len(train), batch_size)]


def pad_schedule(per_rank: List[List[np.ndarray]]) -> List[List[np.ndarray]]:
    """``schedule[step][rank]`` from per-rank batch lists, padded with empty
    seed arrays: every rank takes the same number of synchronized steps and
    no seed is ever trained twice (short ranks contribute fully masked
    batches instead of wrapping around)."""
    steps = max((len(b) for b in per_rank), default=0)
    empty = np.empty(0, np.int64)
    return [[b[k] if k < len(b) else empty for b in per_rank]
            for k in range(steps)]
