"""Static halo-exchange tables, computed once per partitioning (own numpy
copy of the parts of ``repro/comm/plan.py`` the port reads):

  * ``push_mask [R, R, P]`` — ``push_mask[i, j, p]``: solid VID_p ``p`` of
    rank i is a halo on rank j.  The AEP push tests membership with ONE
    boolean gather into it.
  * ``send_local[i][j]`` / ``recv_pos[i][j]`` — the gather/scatter index
    vectors of one exact halo exchange (distributed offline inference):
    rank j receives ``h_solid[i][send_local[i][j]]`` into its halo rows
    at ``recv_pos[i][j]``; ``num_halo [R]`` sizes the receive buffers.
  * :func:`hot_set_tables` — the degree-ranked hot set of the replicated
    hot-vertex tier (sharded serving).

The padded ``db_halo`` table, the sorted owner tables (sync mode) and the
removal of hot vertices from the push contract wait for the slices that
read them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

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


def partition_degrees(ps: PartitionSet) -> np.ndarray:
    """Global vertex degrees ``[V]`` from the per-partition CSRs (every
    vertex is solid in exactly one partition, and its local CSR row holds
    its full neighbor list, halos included)."""
    deg = np.zeros(len(ps.owner), np.int64)
    for p in ps.parts:
        deg[p.solid_vids] = p.indptr[1:] - p.indptr[:-1]
    return deg


def hot_set_tables(ps: PartitionSet, hot_size: int):
    """Degree-ranked hot set: ``(hot_vids [K], hot_owner [K],
    hot_replicas [K])``, sorted by VID_o (slot lookup is one
    ``searchsorted``).

    Candidates are vertices that are a halo on at least one rank; among
    them the top ``hot_size`` by degree (ties by vid).
    ``hot_replicas[k]`` counts the ranks holding ``hot_vids[k]`` as a
    halo."""
    if hot_size <= 0 or ps.num_parts <= 1:
        z = np.empty(0, np.int32)
        return z, z.copy(), np.empty(0, np.int64)
    halos = np.concatenate([p.halo_vids for p in ps.parts])
    cand, reps = np.unique(halos, return_counts=True)
    if not len(cand):
        z = np.empty(0, np.int32)
        return z, z.copy(), np.empty(0, np.int64)
    deg = partition_degrees(ps)[cand]
    order = np.lexsort((cand, -deg))[:hot_size]
    keep = np.sort(order)                       # vid-ascending hot table
    return (cand[keep].astype(np.int32),
            ps.owner[cand[keep]].astype(np.int32),
            reps[keep].astype(np.int64))


@dataclasses.dataclass
class ExchangePlan:
    """Precomputed static exchange tables for one ``PartitionSet``."""
    num_ranks: int
    push_mask: np.ndarray          # [R, R, P] bool (P = padded VID_p width)
    num_halo: np.ndarray           # [R] int64: halo replicas per rank
    # offline-exchange index vectors (None when host_indices=False):
    send_local: Optional[List[List[np.ndarray]]] = None  # [i][j]: rows i -> j
    recv_pos: Optional[List[List[np.ndarray]]] = None    # [i][j]: halo slots

    def device_tables(self, device) -> dict:
        """The ``[R, ...]``-stacked tables the training step reads."""
        return {"push_mask": torch.as_tensor(self.push_mask, device=device)}


def build_exchange_plan(ps: PartitionSet,
                        host_indices: bool = True) -> ExchangePlan:
    """Derive the exchange tables from the partition: rank i pushes to rank
    j the solids of i that j holds as halos (``ps.db_halo(i, j)``).
    ``host_indices=False`` skips the offline exchange's index vectors
    (the trainer does not read them)."""
    R = ps.num_parts
    P = max(p.num_solid + p.num_halo for p in ps.parts)
    push_mask = np.zeros((R, R, P), bool)
    send_local = [[np.empty(0, np.int64)] * R
                  for _ in range(R)] if host_indices else None
    recv_pos = [[np.empty(0, np.int64)] * R
                for _ in range(R)] if host_indices else None
    for i in range(R):
        pi = ps.parts[i]
        for j in range(R):
            vids = ps.db_halo(i, j)
            if i != j and len(vids):
                # db vids are owned by i: membership over i's solid VID_p
                push_mask[i, j, :pi.num_solid] = np.isin(
                    pi.solid_vids, vids, assume_unique=True)
                if host_indices:
                    _, local = ps.route(vids)
                    send_local[i][j] = local.astype(np.int64)
                    recv_pos[i][j] = np.searchsorted(
                        ps.parts[j].halo_vids, vids).astype(np.int64)
    return ExchangePlan(
        num_ranks=R, push_mask=push_mask,
        num_halo=np.array([p.num_halo for p in ps.parts], np.int64),
        send_local=send_local, recv_pos=recv_pos)
