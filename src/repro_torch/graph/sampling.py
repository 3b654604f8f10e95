"""Minibatch block layout (own copy of ``repro/graph/sampling.py``'s
``MinibatchBlocks`` and ``layer_capacities``).

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
