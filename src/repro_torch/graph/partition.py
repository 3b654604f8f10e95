"""Min-edge-cut graph partitioning with training-vertex balance (paper §3.1).

METIS is not available offline; this is a streaming LDG-style greedy
partitioner that preserves the paper's *contract*:
  * every vertex has exactly one owner ("solid" in its partition),
  * training vertices are balanced across partitions (hard capacity),
  * cut edges create "halo" vertices: if edge (u,v) is cut, v appears as a
    feature-less halo replica v' in u's partition (and vice versa),
  * per-partition lookup tables map VID_p <-> VID_o, and
  * db_halo[i][j] lists the VID_o owned by rank i that are halos on rank j
    (what rank i must push to rank j under AEP).

Own numpy copy of ``repro/graph/partition.py``: the same graph and seed
give the same ``Partition`` bit for bit (``tests/test_torch_graph.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.graph.graph import Graph


@dataclasses.dataclass
class Partition:
    part_id: int
    solid_vids: np.ndarray     # [S] VID_o of owned vertices
    halo_vids: np.ndarray      # [H] VID_o of remote vertices seen locally
    halo_owner: np.ndarray     # [H] owner rank of each halo
    indptr: np.ndarray         # [S+1] local CSR (rows = solids only)
    indices: np.ndarray        # [E_loc] neighbor VID_p (0..S+H)
    features: np.ndarray       # [S, F]
    labels: np.ndarray         # [S]
    train_mask: np.ndarray     # [S]
    test_mask: np.ndarray      # [S]

    @property
    def num_solid(self) -> int:
        return len(self.solid_vids)

    @property
    def num_halo(self) -> int:
        return len(self.halo_vids)

    def vid_p_to_o(self) -> np.ndarray:
        return np.concatenate([self.solid_vids, self.halo_vids])

    def is_halo_p(self, vid_p: np.ndarray) -> np.ndarray:
        return vid_p >= self.num_solid


@dataclasses.dataclass
class PartitionSet:
    parts: List[Partition]
    owner: np.ndarray          # [V] rank owning each VID_o
    local_index: np.ndarray    # [V] solid VID_p of each VID_o in its owner
    edge_cut_frac: float

    @property
    def num_parts(self) -> int:
        return len(self.parts)

    def route(self, vids: np.ndarray):
        """O(1) owner routing: ``(owner_rank, local_index)`` per VID_o —
        one gather each into the ``owner`` / ``local_index`` tables;
        ``local_index[v]`` is the solid VID_p of ``v`` inside
        ``parts[owner[v]]``.  Out-of-range vids raise (a negative index
        would otherwise wrap around and route to the wrong owner)."""
        vids = np.asarray(vids)
        if len(vids) and (vids.min() < 0 or vids.max() >= len(self.owner)):
            raise ValueError(
                f"vid out of range [0, {len(self.owner)}): "
                f"{vids[(vids < 0) | (vids >= len(self.owner))][:5]}")
        return self.owner[vids], self.local_index[vids]

    def db_halo(self, i: int, j: int) -> np.ndarray:
        """VID_o owned by rank i that rank j holds as halos (sorted)."""
        pj = self.parts[j]
        return np.sort(pj.halo_vids[pj.halo_owner == i])


def _assign_parts(g: Graph, nparts: int, seed: int) -> np.ndarray:
    """Streaming greedy: neighbor affinity − load penalty, train-balanced."""
    rng = np.random.default_rng(seed)
    V = g.num_vertices
    owner = np.full(V, -1, np.int32)
    cap = int(np.ceil(V / nparts) * 1.05) + 1
    train_cap = int(np.ceil(g.train_mask.sum() / nparts)) + 1
    sizes = np.zeros(nparts, np.int64)
    train_sizes = np.zeros(nparts, np.int64)

    # BFS order from random roots gives locality; fall back to random order
    order = np.empty(V, np.int64)
    visited = np.zeros(V, bool)
    pos = 0
    perm = rng.permutation(V)
    from collections import deque
    dq = deque()
    for root in perm:
        if visited[root]:
            continue
        dq.append(root)
        visited[root] = True
        while dq:
            v = dq.popleft()
            order[pos] = v
            pos += 1
            for nb in g.neighbors(v):
                if not visited[nb]:
                    visited[nb] = True
                    dq.append(nb)
    assert pos == V

    score = np.empty(nparts, np.float64)
    for v in order:
        nbrs = g.neighbors(v)
        counts = np.zeros(nparts, np.float64)
        no = owner[nbrs]
        no = no[no >= 0]
        if len(no):
            np.add.at(counts, no, 1.0)
        np.multiply(1.0 - sizes / cap, counts + 1e-3, out=score)
        score[sizes >= cap] = -np.inf
        if g.train_mask[v]:
            score[train_sizes >= train_cap] = -np.inf
        p = int(np.argmax(score))
        owner[v] = p
        sizes[p] += 1
        if g.train_mask[v]:
            train_sizes[p] += 1
    return owner


def partition_graph(g: Graph, nparts: int, seed: int = 0) -> PartitionSet:
    if nparts == 1:
        owner = np.zeros(g.num_vertices, np.int32)
    else:
        owner = _assign_parts(g, nparts, seed).astype(np.int32)

    V = g.num_vertices
    local_index = np.zeros(V, np.int64)
    parts: List[Partition] = []
    cut_edges = 0
    for p in range(nparts):
        solid = np.flatnonzero(owner == p).astype(np.int64)
        S = len(solid)
        local_index[solid] = np.arange(S)
        parts.append(None)  # placeholder; fill after local_index complete

    for p in range(nparts):
        solid = np.flatnonzero(owner == p).astype(np.int64)
        S = len(solid)
        # local CSR over solids; neighbors may be halos
        deg = g.indptr[solid + 1] - g.indptr[solid]
        indptr = np.zeros(S + 1, np.int64)
        indptr[1:] = np.cumsum(deg)
        E = int(indptr[-1])
        nbr_o = np.empty(E, np.int64)
        for i, v in enumerate(solid):
            nbr_o[indptr[i]:indptr[i + 1]] = g.indices[g.indptr[v]:g.indptr[v + 1]]
        remote = owner[nbr_o] != p
        cut_edges += int(remote.sum())
        halo_vids = np.unique(nbr_o[remote])
        halo_pos = {int(h): S + k for k, h in enumerate(halo_vids)}
        indices = np.empty(E, np.int64)
        own_nbr = ~remote
        indices[own_nbr] = local_index[nbr_o[own_nbr]]
        if remote.any():
            indices[remote] = np.array([halo_pos[int(h)] for h in nbr_o[remote]])
        parts[p] = Partition(
            part_id=p,
            solid_vids=solid,
            halo_vids=halo_vids.astype(np.int64),
            halo_owner=owner[halo_vids].astype(np.int32),
            indptr=indptr,
            indices=indices.astype(np.int64),
            features=g.features[solid],
            labels=g.labels[solid],
            train_mask=g.train_mask[solid],
            test_mask=g.test_mask[solid],
        )
    return PartitionSet(parts=parts, owner=owner,
                        local_index=local_index,
                        edge_cut_frac=cut_edges / max(g.num_edges, 1))
