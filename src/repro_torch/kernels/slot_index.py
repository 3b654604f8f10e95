"""The transposed slot index that the fixed-order gradients of GraphSAGE's
AGG (kernel F) and GAT's AGG (kernel H) gather through.

For a neighbor matrix ``nbr [M, f]`` over ``num_src`` source rows, the
gradient keeps the slots ``s = m * f + j`` with ``0 <= nbr[m, j] <
num_src`` and ``src_valid[nbr[m, j]]`` (an index past the last row is
clamped by the forward's gather but dropped by its gradient).
:func:`slot_index` lists them by source row, each row's in ascending
``s``, as CSR: ``offsets [N + 1]`` and ``slots [M * f]`` (the kept ones
first).  A row of more than :data:`CHUNK` slots is walked in chunks
(``csrc/slot_index.cuh``): ``lbase [N + 1]`` numbers them, and ``lbound``
bounds their count from the shapes alone, so no launch waits for the
device.

The build is integer work: a stable sort of the kept slots by source row
and a binary search for the offsets, which give the same result whatever
the order the device runs them in.  It runs where its inputs lie, with
the same ops on the CPU and the card; the forward builds it on the card
(``SageAgg``, ``GatEdge``) once per rank and layer, the backward reads it.
``slot_index.launches`` counts the builds on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["CHUNK", "SlotIndex", "slot_index"]

CHUNK = 128                     # csrc/slot_index.cuh: slot_index::CHUNK


@dataclasses.dataclass
class SlotIndex:
    """The transposed index of one neighbor matrix: ``offsets [N + 1]``,
    ``slots [M * f]`` and ``lbase [N + 1]`` int32 on the matrix's device,
    ``lbound`` (host) at least ``lbase[N]``."""
    offsets: torch.Tensor
    slots: torch.Tensor
    lbase: torch.Tensor
    num_src: int
    lbound: int


def slot_index(nbr_idx: torch.Tensor, src_valid: Optional[torch.Tensor],
               num_src: int) -> SlotIndex:
    """The kept slots of ``nbr_idx [M, f]`` (int32) by source row in
    ascending slot order; ``src_valid [num_src]`` bool, or None where
    every source counts."""
    dev = nbr_idx.device
    flat = nbr_idx.reshape(-1)
    kept = (flat >= 0) & (flat < num_src)
    if src_valid is not None and num_src:
        kept &= src_valid[flat.long().clamp(0, num_src - 1)]
    keys = torch.where(kept, flat.to(torch.int32),
                       torch.full((), num_src, dtype=torch.int32, device=dev))
    sorted_keys, perm = torch.sort(keys, stable=True)
    offsets = torch.searchsorted(
        sorted_keys, torch.arange(num_src + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    lens = offsets[1:] - offsets[:-1]
    chunks = torch.where(lens > CHUNK, (lens + CHUNK - 1) // CHUNK,
                         torch.zeros((), dtype=lens.dtype, device=dev))
    lbase = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum(chunks, 0).to(torch.int32)])
    if dev.type == "cuda":
        slot_index.launches += 1
    return SlotIndex(offsets=offsets, slots=perm.to(torch.int32),
                     lbase=lbase, num_src=int(num_src),
                     lbound=-(-2 * flat.numel() // CHUNK))


slot_index.launches = 0
