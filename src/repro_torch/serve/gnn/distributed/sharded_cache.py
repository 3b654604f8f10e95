"""Sharded serving cache: the stacked policy of
``repro_torch.cache.hec.EmbeddingCache`` (counterpart of
``repro/serve/gnn/distributed/sharded_cache.py``).

Per layer one HEC state stacked ``[R, ...]`` over the shards, **VID_o**
tags (a shard caches embeddings of vertices it does not own, so fetched
halos stop traveling), per-shard residency mirrors, owner-routed
``warm``, halo-gather counters, and model-version invalidation that
drops every line on every shard at once.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.cache.hec import EmbeddingCache, ServeCacheConfig
from repro_torch.device import DeviceLike
from repro_torch.graph.partition import PartitionSet


class ShardedServingCache(EmbeddingCache):
    """Per-rank stacked serving cache over a ``PartitionSet``."""

    def __init__(self, dims: Sequence[int], ps: PartitionSet,
                 cfg: Optional[ServeCacheConfig] = None,
                 device: DeviceLike = None):
        super().__init__(dims, len(ps.owner), cfg=cfg, ps=ps, device=device)
