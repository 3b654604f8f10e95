"""Partition-aware query routing for sharded GNN serving (own copy of
``repro/serve/gnn/distributed/router.py``).

Every queried vertex has exactly one owner shard, so routing is one
``PartitionSet.route`` gather: owner rank + solid VID_p.  The router keeps
one FIFO per shard; the scheduler packs synchronized rounds of up to
``num_slots`` seeds per rank from them, so every round has the same
``[R, slots]`` shape however skewed the query stream is (a rank with
nothing queued runs an empty, fully masked microbatch).
"""
from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np

from repro_torch.graph.partition import PartitionSet


class QueryRouter:
    """Owner routing + per-rank FIFOs."""

    def __init__(self, ps: PartitionSet):
        self.ps = ps
        self.num_ranks = ps.num_parts
        self.queues: List[deque] = [deque() for _ in range(ps.num_parts)]

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues)

    def enqueue(self, req) -> int:
        """Route ``req.vid`` (VID_o) to its owner's queue; returns the rank.
        The entry carries the owner-local solid VID_p, the id space the
        shard samples in."""
        owner, local = self.ps.route(np.asarray([req.vid]))
        r = int(owner[0])
        self.queues[r].append((req, int(local[0])))
        return r

    def drain(self, rank: int, max_n: int) -> List[Tuple[object, int]]:
        """Pop up to ``max_n`` routed entries from one shard's queue."""
        q = self.queues[rank]
        n = min(len(q), max_n)
        return [q.popleft() for _ in range(n)]
