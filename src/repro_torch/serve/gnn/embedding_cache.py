"""HEC-backed serving cache: the single-rank
``repro_torch.cache.hec.EmbeddingCache`` under its serving name.

One ``HECState`` per GNN layer output ``h^k`` for ``k = 1..L``, tags in the
partition's local vertex id space.  No life-span ticks (entries live until
OCF eviction or a model-version bump), a host residency mirror driving the
sampler's leaf decisions, and hit/miss/occupancy counters.
"""
from __future__ import annotations

from repro_torch.cache.hec import (EmbeddingCache,  # noqa: F401 (re-export)
                                   ServeCacheConfig)

ServingCache = EmbeddingCache
