"""The Asynchronous Embedding Push's delay queue (own copy of
``repro/core/aep.py``'s ``queue_init`` and ``queue_pop_push``).

One rank's queue holds ``delay`` pushes in flight: slot 0 is consumed
(HECStore'd) this step, and this step's push is appended at the end, so
a push lands ``delay`` steps after it was sent — the paper's bounded
staleness.  The analytic byte models of the reference stay with its
benchmarks.
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
