"""Layer-wise offline (full-graph, exact) GNN inference — counterpart of
``repro/serve/gnn/offline.py`` for GraphSAGE and GAT.

Materializes h^1 for EVERY vertex from h^0, then h^2 from h^1, ... — each
vertex's layer-k embedding is computed exactly once, from its *full*
neighbor list (no sampling), in chunks of dst vertices, whose rows are
addressed by vertex id and not as a prefix: each layer's
``offline_chunk_fn`` says how (GraphSAGE: one fused serve-layer launch
per chunk with ``self_idx``; GAT: one projection of every vertex, then
one GAT AGG launch per chunk with ``dst_idx``).  Used to pre-warm the
serving cache and as the exactness reference of the serving tests.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.graph.partition import Partition
from repro_torch.models.gnn import model_class


def serve_layer_dims(cfg) -> List[int]:
    """Dim of h^k for k = 1..L (hidden layers then the output layer)."""
    return [cfg.hidden_width] * (cfg.num_layers - 1) + [cfg.num_classes]


def full_neighbor_matrix(part: Partition,
                         width: int | None = None) -> np.ndarray:
    """Dense padded neighbor lists ``[S, width]`` (-1 pad) from the CSR;
    ``width`` defaults to the partition's max degree."""
    S = part.num_solid
    deg = part.indptr[1:] - part.indptr[:-1]
    w = width if width is not None else max(int(deg.max()) if S else 0, 1)
    if S and w < int(deg.max()):
        raise ValueError(f"width {w} < max degree {int(deg.max())}")
    if len(part.indices) == 0:
        return np.full((S, w), -1, np.int64)
    col = np.arange(w)
    in_row = col[None, :] < deg[:, None]
    gi = np.minimum(part.indptr[:-1][:, None] + col[None, :],
                    len(part.indices) - 1)
    return np.where(in_row, part.indices[gi], -1)


def _check_model(cfg, model):
    if not isinstance(model, model_class(cfg.model)):
        raise ValueError(f"model {type(model).__name__} does not serve "
                         f"config model {cfg.model!r}")
    if model.num_layers != cfg.num_layers:
        raise ValueError(f"model has {model.num_layers} layers, config "
                         f"{cfg.num_layers}")


@torch.no_grad()
def layerwise_embeddings(cfg, model, part: Partition,
                         chunk_size: int = 2048) -> List[torch.Tensor]:
    """Exact full-graph embeddings ``[h^1, ..., h^L]`` (each ``[S, d_k]``),
    on the model's device."""
    _check_model(cfg, model)
    if part.num_halo:
        raise ValueError("offline inference is single-partition")
    dev = next(model.parameters()).device
    S = part.num_solid
    nbr_full = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                               device=dev)
    vids = torch.arange(S, dtype=torch.int32, device=dev)
    valid = torch.ones(S, dtype=torch.bool, device=dev)
    h = torch.as_tensor(part.features, dtype=torch.float32, device=dev)
    outs: List[torch.Tensor] = []
    for l, layer in enumerate(model.layers):
        chunk_fn = layer.offline_chunk_fn(h, valid,
                                          last=l == model.num_layers - 1)
        h = torch.cat([chunk_fn(nbr_full[s:s + chunk_size],
                                vids[s:s + chunk_size])
                       for s in range(0, S, chunk_size)])
        outs.append(h)
    return outs


@torch.no_grad()
def direct_forward(cfg, model, part: Partition) -> torch.Tensor:
    """Unchunked full-graph forward through the model's own ``forward`` —
    the independent reference ``layerwise_embeddings`` must match."""
    _check_model(cfg, model)
    if part.num_halo:
        raise ValueError("offline inference is single-partition")
    dev = next(model.parameters()).device
    nbr = torch.as_tensor(full_neighbor_matrix(part), dtype=torch.int32,
                          device=dev)
    h0 = torch.as_tensor(part.features, dtype=torch.float32, device=dev)
    valid0 = torch.ones(part.num_solid, dtype=torch.bool, device=dev)
    out, _ = model(h0, valid0, {"nbr_idx": [nbr] * cfg.num_layers})
    return out


def warm_cache(cache, embeddings: List[torch.Tensor], vids,
               chunk: int = 4096) -> int:
    """Store offline embeddings of ``vids`` into every cache layer; returns
    the number of vertices stored per layer."""
    return cache.warm(embeddings, vids, chunk=chunk)
