"""Distributed layer-wise offline inference: sharded, exact, one halo
exchange per layer (counterpart of
``repro/serve/gnn/distributed/offline.py``).

At layer ``l`` every shard needs the ``h^l`` of its halo replicas, so
before computing layer ``l+1`` each rank receives them from their owners
(``HaloExchangeEngine.exchange_halos_host``, ONE exchange per layer,
sized by the edge cut).  Each shard then runs the model's own
``offline_chunk_fn`` over its solids (GraphSAGE: one fused serve-layer
launch per chunk; GAT: one projection of the shard's solids and halos,
then one GAT AGG launch per chunk), with its neighbor lists padded to
the **global** max degree, as the single-rank engine does on the whole
graph.  Used to pre-warm every serving shard and as the exactness
reference of the sharded serving tests.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.comm.engine import HaloExchangeEngine
from repro_torch.graph.partition import PartitionSet
from repro_torch.serve.gnn.offline import (_check_model,
                                           full_neighbor_matrix,
                                           serve_layer_dims)


def global_neighbor_width(ps: PartitionSet) -> int:
    """Global max degree — the shared neighbor-matrix pad width."""
    w = 1
    for p in ps.parts:
        if p.num_solid:
            w = max(w, int((p.indptr[1:] - p.indptr[:-1]).max()))
    return w


def exchange_halos(ps: PartitionSet, h_solid: Sequence[torch.Tensor]) \
        -> Tuple[List[torch.Tensor], int]:
    """One exact halo exchange through a throwaway plan; loops over layers
    build the engine once, as :func:`layerwise_embeddings_dist` does."""
    return HaloExchangeEngine.from_partition(ps).exchange_halos_host(h_solid)


@torch.no_grad()
def layerwise_embeddings_dist(cfg, model, ps: PartitionSet,
                              chunk_size: int = 2048,
                              with_stats: bool = False):
    """Exact full-graph embeddings ``[h^1, ..., h^L]`` in GLOBAL vertex
    order (each ``[V, d_k]``, on the model's device), computed shard by
    shard with exactly one halo exchange per layer."""
    _check_model(cfg, model)
    dev = next(model.parameters()).device
    V = len(ps.owner)
    L = cfg.num_layers
    dims = serve_layer_dims(cfg)
    engine = HaloExchangeEngine.from_partition(ps, num_layers=L)
    w = global_neighbor_width(ps)
    nbr_full = [torch.as_tensor(full_neighbor_matrix(p, width=w),
                                dtype=torch.int32, device=dev)
                for p in ps.parts]
    h_solid = [torch.as_tensor(p.features, dtype=torch.float32, device=dev)
               for p in ps.parts]
    outs: List[torch.Tensor] = []
    bytes_exchanged = 0
    for l, layer in enumerate(model.layers):
        halo_rows, nb = engine.exchange_halos_host(h_solid)
        bytes_exchanged += nb
        nxt: List[torch.Tensor] = []
        for r, part in enumerate(ps.parts):
            S = part.num_solid
            h_all = torch.cat([h_solid[r], halo_rows[r]]) \
                if part.num_halo else h_solid[r]
            valid = torch.ones(h_all.shape[0], dtype=torch.bool, device=dev)
            chunk_fn = layer.offline_chunk_fn(h_all, valid, last=l == L - 1)
            ids = torch.arange(S, dtype=torch.int32, device=dev)
            nxt.append(torch.cat([chunk_fn(nbr_full[r][s:s + chunk_size],
                                           ids[s:s + chunk_size])
                                  for s in range(0, S, chunk_size)])
                       if S else torch.zeros((0, dims[l]), device=dev))
        h_solid = nxt
        g = torch.zeros((V, dims[l]), dtype=torch.float32, device=dev)
        for r, part in enumerate(ps.parts):
            g[torch.as_tensor(part.solid_vids, device=dev)] = h_solid[r]
        outs.append(g)
    if with_stats:
        return outs, {"bytes_exchanged": bytes_exchanged,
                      "exchanges": L, "neighbor_width": w}
    return outs
