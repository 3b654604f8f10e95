"""Static halo-exchange tables, computed once per partitioning (own numpy
copy of the part of ``repro/comm/plan.py`` the ``aep`` training step
reads): ``push_mask [R, R, P]``, where ``push_mask[i, j, p]`` says that
solid VID_p ``p`` of rank i is a halo on rank j.  The AEP push tests
membership with ONE boolean gather into it.

The padded ``db_halo`` table, the sorted owner tables (sync mode), the
offline exchange's index vectors and the hot-vertex set wait for the
slices that read them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.partition import PartitionSet


def _pad_stack(arrays, pad_value=0, dtype=None) -> np.ndarray:
    """Stack ragged per-rank arrays into ``[R, max_len, ...]`` with padding."""
    n = max(len(a) for a in arrays)
    rest = arrays[0].shape[1:]
    out = np.full((len(arrays), n) + rest, pad_value,
                  dtype or arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
    return out


@dataclasses.dataclass
class ExchangePlan:
    """Precomputed static exchange tables for one ``PartitionSet``."""
    num_ranks: int
    push_mask: np.ndarray          # [R, R, P] bool (P = padded VID_p width)

    def device_tables(self, device) -> dict:
        """The ``[R, ...]``-stacked tables the training step reads."""
        return {"push_mask": torch.as_tensor(self.push_mask, device=device)}


def build_exchange_plan(ps: PartitionSet) -> ExchangePlan:
    """Derive the push contract from the partition: rank i pushes to rank
    j the solids of i that j holds as halos (``ps.db_halo(i, j)``)."""
    R = ps.num_parts
    P = max(p.num_solid + p.num_halo for p in ps.parts)
    push_mask = np.zeros((R, R, P), bool)
    for i in range(R):
        pi = ps.parts[i]
        for j in range(R):
            vids = ps.db_halo(i, j)
            if i != j and len(vids):
                # db vids are owned by i: membership over i's solid VID_p
                push_mask[i, j, :pi.num_solid] = np.isin(
                    pi.solid_vids, vids, assume_unique=True)
    return ExchangePlan(num_ranks=R, push_mask=push_mask)
