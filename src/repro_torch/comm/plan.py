"""Static halo-exchange tables, computed once per partitioning (own numpy
copy of the parts of ``repro/comm/plan.py`` the port reads):

  * ``push_mask [R, R, P]`` — ``push_mask[i, j, p]``: solid VID_p ``p`` of
    rank i is a halo on rank j.  The AEP push tests membership with ONE
    boolean gather into it.
  * ``send_local[i][j]`` / ``recv_pos[i][j]`` — the gather/scatter index
    vectors of one exact halo exchange (distributed offline inference):
    rank j receives ``h_solid[i][send_local[i][j]]`` into its halo rows
    at ``recv_pos[i][j]``; ``num_halo [R]`` sizes the receive buffers.
  * ``solid_sorted_vids/idx [R, S]`` — per rank its solid VID_o sorted
    ascending (sentinel-padded) and the matching VID_p: any rank answers
    "which feature row is VID_o v?" with one ``searchsorted`` + gather
    (the ``sync`` mode's fetch).
  * :func:`hot_set_tables` — the degree-ranked hot set of the replicated
    hot-vertex tier (sharded serving; training with ``hot_size > 0``,
    where the hot vertices also leave the push contract).

The padded ``db_halo`` table stays with the reference: the push contract
travels as ``push_mask``, the offline exchange as its index vectors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.graph.partition import PartitionSet

_SENTINEL = np.int32(2 ** 30)    # sorts after every real VID_o


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


def solid_lookup_tables(ps: PartitionSet):
    """Per-rank sorted owner tables: ``(vids [R, Smax], idx [R, Smax])``,
    int32.  ``vids[r]`` is rank r's solid VID_o ascending (padded with a
    sentinel above every vid), ``idx[r]`` the matching solid VID_p."""
    svids, sidx = [], []
    for p in ps.parts:
        vs = np.sort(p.solid_vids)
        _, li = ps.route(vs)
        svids.append(vs.astype(np.int32))
        sidx.append(li.astype(np.int32))
    return (_pad_stack(svids, _SENTINEL), _pad_stack(sidx, 0))


@dataclasses.dataclass
class ExchangePlan:
    """Precomputed static exchange tables for one ``PartitionSet``."""
    num_ranks: int
    push_mask: np.ndarray          # [R, R, P] bool (P = padded VID_p width)
    num_halo: np.ndarray           # [R] int64: halo replicas per rank
    solid_sorted_vids: np.ndarray  # [R, S] int32, sentinel pad
    solid_sorted_idx: np.ndarray   # [R, S] int32
    # offline-exchange index vectors (None when host_indices=False):
    send_local: Optional[List[List[np.ndarray]]] = None  # [i][j]: rows i -> j
    recv_pos: Optional[List[List[np.ndarray]]] = None    # [i][j]: halo slots
    # hot-vertex tier tables (empty when hot_size=0):
    hot_vids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int32))   # [K] sorted VID_o
    hot_owner: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int32))   # [K] owner rank

    @property
    def hot_size(self) -> int:
        return len(self.hot_vids)

    def device_tables(self, device) -> dict:
        """The ``[R, ...]``-stacked tables the training step reads; with a
        hot set also ``hot_vids [R, K]`` (every rank's copy the same) and
        ``hot_mine [R, K]`` (the slots each rank owns)."""
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        out = {"push_mask": t(self.push_mask),
               "solid_sorted_vids": t(self.solid_sorted_vids),
               "solid_sorted_idx": t(self.solid_sorted_idx)}
        if self.hot_size:
            R = self.num_ranks
            out["hot_vids"] = t(np.ascontiguousarray(
                np.broadcast_to(self.hot_vids, (R, self.hot_size))))
            out["hot_mine"] = t(self.hot_owner[None, :]
                                == np.arange(R)[:, None])
        return out


def build_exchange_plan(ps: PartitionSet, host_indices: bool = True,
                        hot_size: int = 0) -> ExchangePlan:
    """Derive the exchange tables from the partition: rank i pushes to rank
    j the solids of i that j holds as halos (``ps.db_halo(i, j)``).
    ``host_indices=False`` skips the offline exchange's index vectors
    (the trainer does not read them).  ``hot_size=K`` derives the hot set
    and removes its vertices from ``push_mask`` (the hot tier refreshes
    them); the offline indices still move every halo row.  ``hot_size=0``
    leaves ``push_mask`` as it is without a tier."""
    R = ps.num_parts
    hot_vids, hot_owner, _ = hot_set_tables(ps, hot_size)
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
                # db vids are owned by i: membership over i's solid VID_p;
                # hot vids leave the pairwise contract
                cold = vids if not len(hot_vids) else \
                    vids[~np.isin(vids, hot_vids, assume_unique=True)]
                push_mask[i, j, :pi.num_solid] = np.isin(
                    pi.solid_vids, cold, assume_unique=True)
                if host_indices:
                    _, local = ps.route(vids)
                    send_local[i][j] = local.astype(np.int64)
                    recv_pos[i][j] = np.searchsorted(
                        ps.parts[j].halo_vids, vids).astype(np.int64)
    svids, sidx = solid_lookup_tables(ps)
    return ExchangePlan(
        num_ranks=R, push_mask=push_mask,
        num_halo=np.array([p.num_halo for p in ps.parts], np.int64),
        solid_sorted_vids=svids, solid_sorted_idx=sidx,
        send_local=send_local, recv_pos=recv_pos,
        hot_vids=hot_vids, hot_owner=hot_owner)
