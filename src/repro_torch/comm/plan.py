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
  * the reference's row models of one exchange, on the plan:
    ``halo_rows_total``, ``hot_rows_total``, ``exchange_bytes`` and
    ``modeled_remote_rows`` (the last reads the contract, ``db_halo``,
    from the plan's ``PartitionSet`` when called; the port's own code
    calls none of them, its tests hold them to the reference's).
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
    pair_rows: np.ndarray          # [R, R] int64: |db_halo(i, j)|
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
    hot_replicas: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, np.int64))   # [K] halo ranks
    # the partition the plan was built for (its db_halo, on demand)
    ps: Optional[PartitionSet] = dataclasses.field(default=None, repr=False)

    @property
    def hot_size(self) -> int:
        return len(self.hot_vids)

    @property
    def halo_rows_total(self) -> int:
        """Rows one exact full exchange moves (sum over off-diagonal pairs)."""
        return int(self.pair_rows.sum() - np.trace(self.pair_rows))

    @property
    def hot_rows_total(self) -> int:
        """Of ``halo_rows_total``, the rows owed for hot vertices: what the
        replicated tier takes off the pairwise wire."""
        return int(self.hot_replicas.sum())

    def exchange_bytes(self, dim: int, itemsize: int = 4) -> int:
        """Exact payload (+ vid tags) of one full halo exchange at ``dim``."""
        return self.halo_rows_total * (dim * itemsize + 4)

    def modeled_remote_rows(self, degrees: np.ndarray, rounds: int = 1,
                            refresh_every: int = 1) -> dict:
        """Remote-fetch rows over ``rounds`` sampled rounds, as the
        reference models them: a halo replica of ``v`` travels at the rate
        ``deg(v) / deg_max`` a round (the busiest hub about once a round);
        with the hot tier a hot replica reads the local copy instead, and
        each refresh moves every hot row to the ``R - 1`` other ranks once
        per ``refresh_every`` rounds.  Returns ``rounds``,
        ``refresh_every``, ``baseline_rows``, ``hot_rows`` and
        ``reduction`` (1 - hot / baseline)."""
        degrees = np.asarray(degrees, np.float64)
        w = degrees / max(degrees.max(), 1.0)
        base_round = 0.0
        hot_round = 0.0
        for j in range(self.num_ranks):
            for i in range(self.num_ranks):
                if i == j:
                    continue
                vids = self.ps.db_halo(i, j)
                ws = w[vids]
                base_round += float(ws.sum())
                if self.hot_size:
                    cold = ~np.isin(vids, self.hot_vids, assume_unique=True)
                    hot_round += float(ws[cold].sum())
                else:
                    hot_round += float(ws.sum())
        refreshes = -(-rounds // max(refresh_every, 1))
        base = base_round * rounds
        hot = hot_round * rounds \
            + self.hot_size * (self.num_ranks - 1) * refreshes
        return {"rounds": rounds, "refresh_every": refresh_every,
                "baseline_rows": base, "hot_rows": hot,
                "reduction": 1.0 - hot / base if base else 0.0}

    def expected_inbound_rows(self) -> np.ndarray:
        """[R] plan-time halo rows each rank receives in one full exchange
        (the off-diagonal column sums of ``pair_rows``): the edge-cut
        profile the health plane's drift detector compares the live
        per-rank halo rows against."""
        inbound = self.pair_rows.sum(axis=0) - np.diag(self.pair_rows)
        return inbound.astype(np.int64)

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
    hot_vids, hot_owner, hot_reps = hot_set_tables(ps, hot_size)
    P = max(p.num_solid + p.num_halo for p in ps.parts)
    push_mask = np.zeros((R, R, P), bool)
    send_local = [[np.empty(0, np.int64)] * R
                  for _ in range(R)] if host_indices else None
    recv_pos = [[np.empty(0, np.int64)] * R
                for _ in range(R)] if host_indices else None
    pair_rows = np.zeros((R, R), np.int64)
    for i in range(R):
        pi = ps.parts[i]
        for j in range(R):
            vids = ps.db_halo(i, j)
            pair_rows[i, j] = len(vids)
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
        pair_rows=pair_rows, solid_sorted_vids=svids, solid_sorted_idx=sidx,
        send_local=send_local, recv_pos=recv_pos,
        hot_vids=hot_vids, hot_owner=hot_owner, hot_replicas=hot_reps,
        ps=ps)
