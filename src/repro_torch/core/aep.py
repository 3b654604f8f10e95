"""The Asynchronous Embedding Push's delay queue and its analytic
communication models (own copy of ``repro/core/aep.py``).

One rank's queue holds ``delay`` pushes in flight: slot 0 is consumed
(HECStore'd) this step, and this step's push is appended at the end, so
a push lands ``delay`` steps after it was sent — the paper's bounded
staleness.  The byte models give one step's per-rank payload of the AEP
push and of the DistDGL-like sync fetch, and ``epoch_time_model`` the
paper's epoch-time structure (§4.4); the dry run
(``launch/gnn_dryrun.py``) and ``examples/torch_distributed_gat.py``
print them beside what the port's step moves.
"""
from __future__ import annotations

import torch


def queue_init(delay: int, num_ranks: int, num_layers: int, nc: int,
               dim_max: int, device) -> dict:
    """In-flight buffer: slot 0 is consumed this step; push appends at -1."""
    return {
        "tags": torch.full((delay, num_ranks, num_layers, nc), -1,
                           dtype=torch.int32, device=device),
        "embs": torch.zeros((delay, num_ranks, num_layers, nc, dim_max),
                            dtype=torch.float32, device=device),
    }


def queue_pop_push(queue: dict, new_tags: torch.Tensor,
                   new_embs: torch.Tensor) -> dict:
    """Shift the queue by one step (slot 0 was consumed) and append."""
    return {
        "tags": torch.cat([queue["tags"][1:], new_tags[None]], 0),
        "embs": torch.cat([queue["embs"][1:], new_embs[None]], 0),
    }


def aep_bytes_per_step(num_ranks: int, num_layers: int, nc: int,
                       dims) -> int:
    """Per-rank AEP all_to_all payload per step (tags + per-layer embs)."""
    dmax = max(dims)
    return num_ranks * num_layers * nc * (4 + 4 * dmax)


def sync_bytes_per_step(num_ranks: int, nc_req: int, feat_dim: int) -> int:
    """Per-rank blocking fetch: request tags + feature responses."""
    return num_ranks * nc_req * (4 + 4 * (feat_dim + 1))


def epoch_time_model(num_ranks: int, minibatches: int, compute_s: float,
                     comm_bytes: int, link_bw: float = 50e9,
                     overlap: bool = True) -> float:
    """Paper §4.4 epoch-time structure: overlapped comm hides under compute
    (AEP) vs serialized comm (sync baseline)."""
    comm_s = comm_bytes / link_bw
    per_mb = max(compute_s, comm_s) if overlap else compute_s + comm_s
    return minibatches * per_mb
