"""Minibatch block layout, the reference's per-row sampler and the
epoch's seed schedule (own copy of ``repro/graph/sampling.py``).

Block layout for an L-layer GNN (seeds at layer L-1):
  layer_nodes[k]  [N_k]           VID_p per node (-1 pad); k=0 is input side
  node_mask[k]    [N_k]           valid
  nbr_idx[k]      [N_{k+1}, f_k]  indices INTO layer_nodes[k] (-1 pad);
                                  row r aggregates into layer_nodes[k+1][r]
  (dst nodes are a prefix of the finer layer's node list, so self features
  are read at the same positions.)

Halo vertices are never expanded (their embeddings come from the HEC),
so they appear only as leaves.  The blocks are host numpy arrays with
fixed shapes.  ``sample_blocks`` is the reference's per-row sampler (the
unstaged training path and ``PipelineConfig(vectorized=False)``); the
pipeline's default is ``repro_torch.pipeline.vectorized_sampler``.
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


def sample_blocks(part: Partition, seeds_p: np.ndarray, fanouts: Sequence[int],
                  rng: np.random.Generator, batch_size: int) -> MinibatchBlocks:
    """seeds_p: VID_p of (solid) training seeds, len <= batch_size."""
    fanouts = list(fanouts)
    L = len(fanouts)
    caps = layer_capacities(batch_size, fanouts)   # [N_0 ... N_L], N_L=B
    S = part.num_solid

    seeds = np.full(batch_size, -1, np.int64)
    seeds[:len(seeds_p)] = seeds_p
    seed_mask = seeds >= 0
    labels = np.zeros(batch_size, np.int64)
    labels[seed_mask] = part.labels[seeds[seed_mask]]

    layer_nodes = [None] * (L + 1)
    node_mask = [None] * (L + 1)
    nbr_idx = [None] * L
    layer_nodes[L] = seeds
    node_mask[L] = seed_mask

    cur = seeds
    for k in range(L - 1, -1, -1):          # from seeds toward inputs
        f = fanouts[k]                  # seeds use fanouts[-1], inputs fanouts[0]
        n_dst = len(cur)
        nbrs = np.full((n_dst, f), -1, np.int64)     # VID_p of sampled nbrs
        valid_dst = (cur >= 0) & (cur < S)           # only solids expand
        for r in np.flatnonzero(valid_dst):
            v = cur[r]
            row = part.indices[part.indptr[v]:part.indptr[v + 1]]
            if len(row) == 0:
                continue
            if len(row) <= f:
                nbrs[r, :len(row)] = row
            else:
                pick = rng.choice(len(row), size=f, replace=False)
                nbrs[r] = row[pick]
        # finer node list: dst prefix + unique new neighbors
        flat = nbrs.ravel()
        newn = flat[flat >= 0]
        uniq = np.unique(newn)
        cur_valid = cur[cur >= 0]
        extra = np.setdiff1d(uniq, cur_valid, assume_unique=False)
        cap = caps[k]
        fine = np.full(cap, -1, np.int64)
        fine[:n_dst] = cur
        n_fine = n_dst + len(extra)
        assert n_fine <= cap, (n_fine, cap)
        fine[n_dst:n_fine] = extra
        # map VID_p -> position in fine
        pos_map = {}
        for i in range(n_fine):
            if fine[i] >= 0:
                pos_map[int(fine[i])] = i
        nb_positions = np.full((len(cur), f), -1, np.int64)
        nz = flat >= 0
        if nz.any():
            lookup = np.array([pos_map[int(x)] for x in flat[nz]])
            nb_positions.ravel()[np.flatnonzero(nz)] = lookup
        nbr_idx[k] = nb_positions
        layer_nodes[k] = fine
        node_mask[k] = fine >= 0
        cur = fine

    return MinibatchBlocks(layer_nodes=layer_nodes, node_mask=node_mask,
                           nbr_idx=nbr_idx, seeds=seeds, seed_mask=seed_mask,
                           labels=labels)


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
