"""Cache pre-warm policies (numpy): which vertices deserve offline
embeddings — counterpart of ``repro/serve/gnn/prewarm.py``.

  * **degree** — highest-degree vertices first: hubs appear in a
    disproportionate share of sampled neighborhoods, so caching them buys
    the largest expected leaf rate per cache line.  The default.
  * **query_log** — most-frequently-queried vertices first, from a
    recorded vid log: warms exactly the observed working set.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.graph.partition import Partition


def degree_weighted_vids(part: Partition, k: Optional[int] = None,
                         frac: float = 0.25) -> np.ndarray:
    """Top-``k`` (default ``frac`` of the partition) solid VID_o by degree,
    ties broken by vid for determinism."""
    deg = part.indptr[1:] - part.indptr[:-1]
    if k is None:
        k = max(1, int(round(part.num_solid * frac)))
    order = np.lexsort((part.solid_vids, -deg))
    return np.sort(part.solid_vids[order[:k]])


def query_log_vids(log: Sequence[int], k: Optional[int] = None,
                   frac: float = 1.0) -> np.ndarray:
    """Most-frequently-queried VID_o first (ties by vid), top ``k``."""
    vids, counts = np.unique(np.asarray(log, np.int64), return_counts=True)
    if k is None:
        k = max(1, int(round(len(vids) * frac)))
    order = np.lexsort((vids, -counts))
    return np.sort(vids[order[:k]])


def select_prewarm_vids(parts: Sequence[Partition], policy: str = "degree",
                        frac: Optional[float] = None,
                        query_log: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
    """Policy dispatch.  ``frac=None`` selects the policy's own default:
    0.25 for degree (a hub slice), 1.0 for query_log (the whole observed
    working set)."""
    if policy == "degree":
        return np.concatenate(
            [degree_weighted_vids(p, frac=0.25 if frac is None else frac)
             for p in parts])
    if policy == "query_log":
        if query_log is None or not len(query_log):
            raise ValueError("query_log policy needs a non-empty vid log")
        return query_log_vids(query_log, frac=1.0 if frac is None else frac)
    raise ValueError(f"unknown prewarm policy {policy!r} "
                     f"(expected 'degree' or 'query_log')")



def prewarm(srv, policy: str = "degree", frac: Optional[float] = None,
            query_log: Optional[Sequence[int]] = None,
            chunk_size: int = 2048) -> int:
    """Distributed offline inference + policy-selected warm of a sharded
    scheduler (``DistGNNServeScheduler``): each vid lands on its owner's
    shard, and the hot tier's replicas take the whole hot set from the
    same offline pass.  Returns the number of vertices warmed per
    layer."""
    from repro_torch.serve.gnn.distributed.offline import \
        layerwise_embeddings_dist
    vids = select_prewarm_vids(srv.ps.parts, policy, frac, query_log)
    embs = layerwise_embeddings_dist(srv.cfg, srv.model, srv.ps,
                                     chunk_size=chunk_size)
    if srv.hot is not None:
        srv.hot.warm(embs)
    return srv.cache.warm(embs, vids)
